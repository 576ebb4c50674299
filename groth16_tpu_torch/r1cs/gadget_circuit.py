"""Circuits built from the recursive verifier's gadgets
(`groth16_tpu_torch.gadgets`), each over the scalar field of the outer
curve of a cycle: BW6-761 for BLS12-377 points, MNT6-298 for MNT4-298
points.  The outer curve's r is the inner curve's p, so the outer circuit
does the inner curve's arithmetic natively.

* `G1AddCircuit`: one piece of the verifier at a size a CPU test can
  prove: the complete addition of two inner G1 points (`G1Var.add`, the
  12 product constraints of the RCB law where a = 0, of the bidegree-(2,2)
  law where a != 0), the sum made affine (`G1Var.to_affine`, an inverse
  and two products), and its x bound to the one public input.  The
  witness is the two points.
* `MntVerifierCircuit`: the whole verifier gadget on the MNT cycle, an
  MNT4-298 Groth16 proof verified inside an MNT6-298 circuit (the flow of
  the reference's own cycle test, constraints.rs:452-589): 69,597
  constraints for one inner public input, with no outer public input.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.gadgets import Groth16VerifierGadget, ProofVar, VerifyingKeyVar
from groth16_tpu_torch.gadgets.curve_var import G1Var
from groth16_tpu_torch.gadgets.groth16_var import allocate_input_bits
from groth16_tpu_torch.gadgets.r1cs_std import FpVar
from groth16_tpu_torch.r1cs.system import ConstraintSystem

# inner curve -> the outer curve that proves its circuits (its r is the
# inner curve's p)
CYCLES = {"bls12_377": "bw6_761", "mnt4_298": "mnt6_298"}
INNER = "bls12_377"  # G1AddCircuit's default inner curve
MNT_INNER = "mnt4_298"
MNT_OUTER = CYCLES[MNT_INNER]


def _check_field(cs: ConstraintSystem, inner: str, what: str) -> None:
    if cs.modulus != get_curve(inner).p:
        raise ValueError(f"{what} runs over {inner}'s base field ({CYCLES[inner]}'s r)")


class G1AddCircuit:
    """P + Q on the inner curve's G1 in-circuit; public input: the sum's
    affine x.  P and Q are affine points (None to synthesize the shape
    only), neither infinity, and not each other's negation (the sum must
    be affine).  inner: "bls12_377" (proved with BW6-761) or "mnt4_298"
    (proved with MNT6-298)."""

    def __init__(self, P: Optional[Tuple[int, int]] = None, Q: Optional[Tuple[int, int]] = None,
                 inner: str = INNER):
        if inner not in CYCLES:
            raise ValueError(f"no cycle for inner curve {inner}")
        self.P, self.Q, self.inner = P, Q, inner

    def __call__(self, cs: ConstraintSystem) -> None:
        _check_field(cs, self.inner, "G1AddCircuit")
        c = get_curve(self.inner)
        b3 = 3 * c.b

        def point(pt):
            x = FpVar.new_witness(cs, None if pt is None else pt[0])
            y = FpVar.new_witness(cs, None if pt is None else pt[1])
            return G1Var.from_affine_var(cs, x, y, b3, c.a)

        x, _ = point(self.P).add(point(self.Q)).to_affine()
        FpVar.new_input(cs, x.value).enforce_equal(x)


class MntVerifierCircuit:
    """An MNT4-298 Groth16 proof verified in-circuit over MNT6-298's r
    (tests/test_gadget_mnt.py's flow): the verifier gadget, the verifying
    key and the proof as witnesses, then each of the inner statement's
    `num_inputs` public inputs as little-endian bits of r's width.  The
    inner key, proof and inputs are all witnesses, so the outer statement
    has no public input.  With vk, proof and public_inputs None it
    synthesizes the shape only (setup); a vk sets num_inputs to its
    own."""

    def __init__(self, vk=None, proof=None, public_inputs: Optional[Sequence[int]] = None,
                 num_inputs: int = 1):
        self.vk, self.proof = vk, proof
        self.public_inputs = None if public_inputs is None else list(public_inputs)
        self.num_inputs = num_inputs if vk is None else len(vk.gamma_abc_g1) - 1

    def __call__(self, cs: ConstraintSystem) -> None:
        _check_field(cs, MNT_INNER, "MntVerifierCircuit")
        gadget = Groth16VerifierGadget(cs, MNT_INNER)
        vk_var = VerifyingKeyVar(cs, MNT_INNER, vk=self.vk, num_inputs=self.num_inputs)
        proof_var = ProofVar(cs, self.proof)
        bits = allocate_input_bits(cs, self.public_inputs, self.num_inputs,
                                   get_curve(MNT_INNER).r.bit_length())
        gadget.verify(vk_var, bits, proof_var)
