"""Batch proving and the device assembly of the port on the CPU (every
kernel's plain version) against the JAX package's exact engines:

- `CurveDevice.scalar_mul_bits` (the select loop the scalar-multiplication
  kernel replaces) against `groth16_tpu.ref` on G1 (3 lanes) and G2
  (1 lane), 12-bit scalars with 0, 1 and all ones;
- the device assembly (`prove(host_assembly=False)`: scalar_bits,
  prove_phases, assembly_phase, decode_proof_arrays) from MSM
  accumulators computed by the exact engine, so no CPU MSM runs, against
  `groth16_tpu.protocol.prover.create_proof_with_reduction` for the same
  r and s (r = 0 and s = 0 included);
- `ProofStream`'s order and depth with a stand-in prover.

`prove_batch` of two proofs against the exact prover, the one test of
this set that runs CPU MSMs, is in test_torch_late.py.

Tolerance: equal affine points (exact integers)."""

import functools

import numpy as np
import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.qap.reduction import LibsnarkReduction
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.group import g1_jacobian, g2_jacobian
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.par.batch_pp import ProofStream
from groth16_tpu_torch.protocol import prover_torch
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.prover_torch import TorchProver
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

torch.set_num_threads(1)

NBITS = 12


@pytest.mark.parametrize("curve", ["bn254", "bls12_381"])
@pytest.mark.parametrize("group,scalars", [("g1", (0, 1, (1 << NBITS) - 1)), ("g2", ((1 << NBITS) - 1,))])
def test_scalar_mul_bits_plain_matches_exact(curve, group, scalars):
    c = get_curve(curve)
    ref = RefGroups(curve)
    if group == "g1":
        g, to_dev, from_dev = codec.g1_ops(c), codec.g1_to_device, codec.g1_from_device
        pts = [ref.g1_mul(ref.g1_sample(3), k) for k in (5, 7, 11)][: len(scalars)]
        mul = ref.g1_mul
    else:
        g, to_dev, from_dev = codec.g2_ops(c), codec.g2_to_device, codec.g2_from_device
        pts = [ref.g2_sample(1)]
        mul = ref.g2_mul
    bits = torch.from_numpy(np.array([[(k >> i) & 1 for i in range(NBITS)] for k in scalars], np.int32))
    before = dict(cuda_point.LAUNCHES)
    got = from_dev(c, g, g.scalar_mul_bits(to_dev(c, pts, "cpu"), bits))
    assert cuda_point.LAUNCHES == before  # the plain version on CPU tensors
    assert got == [mul(p, k) if k else None for p, k in zip(pts, scalars)]


@functools.lru_cache(maxsize=None)
def _silly(curve):
    """The exact setup of MySillyCircuit, the prove-mode synthesis of
    a = 3, b = 5, and the exact MSM accumulators of that assignment (the
    four G1 ones affine in canonical lane order, and the G2 one)."""
    c = get_curve(curve)
    jpk, jvk = jsetup(JSilly(), curve, JRng(0x5B))
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    MySillyCircuit(a=3, b=5)(cs)
    z, ni = cs.full_assignment(), cs.num_instance_variables
    h = LibsnarkReduction.witness_map_from_matrices(cs.to_matrices(), c.fr, ni, cs.num_constraints, z)
    g1, g2 = g1_jacobian(c), g2_jacobian(c)
    acc4 = [
        g1.to_affine(g1.msm(q, v))
        for q, v in ((jpk.a_query[1:], z[1:]), (jpk.b_g1_query[1:], z[1:]), (jpk.h_query, h), (jpk.l_query, z[ni:]))
    ]
    b2 = g2.to_affine(g2.msm(jpk.b_g2_query[1:], z[1:]))
    return jpk, jvk, cs, acc4, b2


@pytest.mark.parametrize("r,s", [(0xB3A1, 0x7E5D), (0, 0x1234), (0x4321, 0)])
def test_device_assembly_matches_exact_prover(r, s, monkeypatch):
    """prove(host_assembly=False) on bn254 with the MSM phases replaced by
    the exact engine's accumulators: the device assembly's proof equals
    the exact prover's and verifies (bls12_381 on the card:
    tests/test_torch_cuda.py)."""
    curve = "bn254"
    c = get_curve(curve)
    jpk, jvk, cs, acc4, b2 = _silly(curve)
    monkeypatch.setattr(prover_torch, "msm_g1_phase", lambda dpk, sc: codec.g1_to_device(c, acc4, "cpu"))
    monkeypatch.setattr(
        prover_torch, "msm_g2_phase", lambda dpk, rho: tuple(x[..., 0] for x in codec.g2_to_device(c, [b2], "cpu"))
    )
    prover = TorchProver(proving_key_from_reference(jpk), cs.to_matrices(), device="cpu")
    got = prover.prove(cs.full_assignment(), r, s, host_assembly=False)
    want = create_proof_with_reduction(JSilly(a=3, b=5), jpk, r, s)
    assert (got.curve, got.a, got.b, got.c) == (want.curve, want.a, want.b, want.c)
    assert verify_proof(prepare_verifying_key(prover.pk.vk), got, [15])


class _StandIn:
    """A prover whose prove_encoded returns prepared device-assembly
    outputs (the exact proofs' points, in assembly_phase's layout) and
    logs every call."""

    curve = "bn254"
    c = get_curve("bn254")

    def __init__(self, proofs, log):
        self.outs = [self._arrays(p) for p in proofs]
        self.log = log

    def _arrays(self, proof):
        ac = codec.g1_to_device(self.c, [proof.a, proof.c], "cpu")
        b = codec.g2_to_device(self.c, [proof.b], "cpu")
        inf = torch.tensor([proof.a is None, proof.c is None])
        return (ac[0], ac[1], inf, b[0], b[1], torch.tensor([proof.b is None]))

    def encode_assignment(self, z):
        self.log.append(("encode", z[0]))
        return z[0]

    def prove_encoded(self, i, r, s):
        self.log.append(("prove", i))
        assert (r, s) == (i + 1, i + 2)
        return self.outs[i]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_proof_stream_order_and_depth(depth):
    """Proofs come out in job order; the stream encodes lazily and holds at
    most `depth` proofs enqueued ahead of the one it yields."""
    ref = RefGroups("bn254")
    g, q = ref.g1_sample(3), ref.g2_sample(1)
    n = 5
    proofs = [JProof(curve="bn254", a=ref.g1_mul(g, i + 2), b=ref.g2_mul(q, i + 3), c=ref.g1_mul(g, 9 * i + 1))
              for i in range(n)]
    proofs[2] = JProof(curve="bn254", a=proofs[2].a, b=proofs[2].b, c=None)
    log = []
    stream = ProofStream(_StandIn(proofs, log), depth=depth)
    out = []
    for i, proof in enumerate(stream.prove_all(([j], j + 1, j + 2) for j in range(n))):
        proved = sum(1 for kind, _ in log if kind == "prove")
        assert proved == min(n, i + depth + 1)
        out.append(proof)
    assert [(p.a, p.b, p.c) for p in out] == [(p.a, p.b, p.c) for p in proofs]
    assert [j for kind, j in log if kind == "encode"] == list(range(n))
    with pytest.raises(ValueError):
        ProofStream(_StandIn(proofs, []), depth=0)
