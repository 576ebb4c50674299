"""arkworks-rs/groth16 v0.5.0 src/constraints.rs:452-589: an MNT4-298
Groth16 proof verified inside an MNT6-298 circuit, the program's
`r1cs/gadget_circuit.MntVerifierCircuit` (69,597 constraints, no outer
public input).

The inner statement is constraints.rs's MySillyCircuit (a * b = c, c
public) on MNT4-298, with a and b drawn from the seed; its key and its
proof are made by the program (key generation and prove on the device)
from the seed, and are witnesses of the outer circuit.  The outer
assignment needs a synthesis, so `assignment` gives None.  The circuit's
matrices come from the program's synthesis; the reference checks them
against the digest the configuration pins (`matrices_sha256`) and checks
the assignment row by row.
"""

from __future__ import annotations

import random

from benchmark.lib.draw import field_element
from benchmark.reference.groth16 import circuit_from_rows


class _Rng:
    """The rng interface the program's key generation draws from, over a
    stream of the seed."""

    def __init__(self, g: random.Random):
        self.g = g

    def field_element(self, modulus: int) -> int:
        return field_element(self.g, modulus)

    def nonzero_field_element(self, modulus: int) -> int:
        return field_element(self.g, modulus, nonzero=True)

    def u64(self) -> int:
        return self.g.getrandbits(64)


def draw_values(cfg, rng, r: int, device):
    """The inner MNT4-298 proof made by the program: -> (vk, proof, [c])."""
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

    inner = cfg["circuit"]["inner_curve"]
    ri = get_curve(inner).r
    g = _Rng(rng)
    pk, vk = setup_device(MySillyCircuit(), inner, g, device=device)
    a, b = g.nonzero_field_element(ri), g.nonzero_field_element(ri)
    cs = ConstraintSystem(ri, mode=SynthesisMode.PROVE)
    MySillyCircuit(a=a, b=b)(cs)
    prover = TorchProver(pk, cs.to_matrices(), device=device)
    proof = prover.prove(cs.full_assignment(), g.field_element(ri), g.field_element(ri))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    del prover
    return vk, proof, [a * b % ri]


def assignment(cfg, values, r: int):
    return None


def synthesize(cfg, cs, values=None) -> None:
    from groth16_tpu_torch.r1cs.gadget_circuit import MntVerifierCircuit

    if values is None:
        MntVerifierCircuit(num_inputs=int(cfg["circuit"]["inner_public_inputs"]))(cs)
    else:
        MntVerifierCircuit(*values)(cs)


def reference_circuit(cfg, matrices):
    """-> (Circuit, digest) from the program's matrices."""
    return circuit_from_rows(matrices.num_instance_variables, matrices.num_witness_variables,
                             matrices.a, matrices.b, matrices.c)
