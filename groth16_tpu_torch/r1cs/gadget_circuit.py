"""A small circuit built from the recursive verifier's gadgets
(`groth16_tpu_torch.gadgets`), proved with BW6-761.

BW6-761's scalar field is BLS12-377's base field, so a BW6-761 circuit
does BLS12-377 curve arithmetic natively: that is how the verifier gadget
checks a BLS12-377 proof inside a BW6-761 proof.  This circuit runs one
piece of it, at a size a CPU test can prove: the complete addition of two
BLS12-377 G1 points (`G1Var.add`, the RCB law's 12 product constraints),
the sum made affine (`G1Var.to_affine`, an inverse and two products), and
its x bound to the one public input.  The witness is the two points.
"""

from __future__ import annotations

from typing import Optional, Tuple

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.gadgets.curve_var import G1Var
from groth16_tpu_torch.gadgets.r1cs_std import FpVar
from groth16_tpu_torch.r1cs.system import ConstraintSystem

INNER = "bls12_377"  # the curve whose points the circuit adds
OUTER = "bw6_761"  # the curve that proves it: its r is INNER's p


class G1AddCircuit:
    """P + Q on BLS12-377 G1 in-circuit; public input: the sum's affine
    x.  P and Q are affine points (None to synthesize the shape only),
    neither infinity, and not each other's negation (the sum must be
    affine)."""

    def __init__(self, P: Optional[Tuple[int, int]] = None, Q: Optional[Tuple[int, int]] = None):
        self.P, self.Q = P, Q

    def __call__(self, cs: ConstraintSystem) -> None:
        inner = get_curve(INNER)
        if cs.modulus != inner.p:
            raise ValueError("G1AddCircuit runs over BLS12-377's base field (BW6-761's r)")
        b3 = 3 * inner.b

        def point(pt):
            x = FpVar.new_witness(cs, None if pt is None else pt[0])
            y = FpVar.new_witness(cs, None if pt is None else pt[1])
            return G1Var.from_affine_var(cs, x, y, b3)

        x, _ = point(self.P).add(point(self.Q)).to_affine()
        FpVar.new_input(cs, x.value).enforce_equal(x)
