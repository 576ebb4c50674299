"""The Groth16 verifier gadget: verify an inner-curve proof in-circuit.

Mirrors arkworks-rs/groth16 src/constraints.rs: ProofVar (:32-44),
VerifyingKeyVar (:46-117), PreparedVerifyingKeyVar (:119-128), and
Groth16VerifierGadget's verify / verify_with_processed_vk (:142-303),
instantiated for a BLS12 inner curve whose base field equals the outer
constraint field (BLS12-377 inside BW6-761 — the composition the
reference exercises on the MNT4/MNT6 cycle, :452-589).

Allocation is "unchecked" like the reference's (:165-245): points enter
as affine coordinate variables without subgroup constraints (the setting
assumes an honestly generated VK/proof encoding; on-curve/subgroup
gadgets can be layered on top).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.gadgets.curve_var import G1Var
from groth16_tpu_torch.gadgets.pairing_var import BlsPairingVar
from groth16_tpu_torch.gadgets.r1cs_std import Boolean, FpVar, bits_of


def _alloc_fp(cs, v: Optional[int]) -> FpVar:
    return FpVar.new_witness(cs, v)


def _alloc_g1(cs, pt):
    """Affine (x, y) -> (FpVar, FpVar).  pt None = SETUP-mode allocation
    (no values); the identity is not representable (the reference's
    allocations assume non-identity elements too, constraints.rs:165+)."""
    if pt is None:
        return (_alloc_fp(cs, None), _alloc_fp(cs, None))
    return (_alloc_fp(cs, pt[0]), _alloc_fp(cs, pt[1]))


def _alloc_g2(cs, pt):
    if pt is None:
        return (
            (_alloc_fp(cs, None), _alloc_fp(cs, None)),
            (_alloc_fp(cs, None), _alloc_fp(cs, None)),
        )
    (x0, x1), (y0, y1) = pt
    return (
        (_alloc_fp(cs, x0), _alloc_fp(cs, x1)),
        (_alloc_fp(cs, y0), _alloc_fp(cs, y1)),
    )


def _neg_g2(q):
    x, y = q
    return (x, (-y[0], -y[1]))


class ProofVar:
    """constraints.rs:32-44."""

    def __init__(self, cs, proof=None):
        p = proof
        self.a = _alloc_g1(cs, None if p is None else p.a)
        self.b = _alloc_g2(cs, None if p is None else p.b)
        self.c = _alloc_g1(cs, None if p is None else p.c)


class VerifyingKeyVar:
    """constraints.rs:46-117."""

    def __init__(self, cs, curve: str, vk=None, num_inputs: Optional[int] = None):
        self.curve = curve
        if vk is not None:
            num_inputs = len(vk.gamma_abc_g1) - 1
        assert num_inputs is not None
        self.alpha_g1 = _alloc_g1(cs, None if vk is None else vk.alpha_g1)
        self.beta_g2 = _alloc_g2(cs, None if vk is None else vk.beta_g2)
        self.gamma_g2 = _alloc_g2(cs, None if vk is None else vk.gamma_g2)
        self.delta_g2 = _alloc_g2(cs, None if vk is None else vk.delta_g2)
        self.gamma_abc_g1 = [
            _alloc_g1(cs, None if vk is None else vk.gamma_abc_g1[i])
            for i in range(num_inputs + 1)
        ]


class PreparedVerifyingKeyVar:
    """constraints.rs:119-128 — produced by the in-circuit `prepare`
    (:61-76): e(alpha, beta) computed inside the circuit."""

    def __init__(self, alpha_g1_beta_g2, gamma_g2_neg, delta_g2_neg,
                 gamma_abc_g1):
        self.alpha_g1_beta_g2 = alpha_g1_beta_g2
        self.gamma_g2_neg = gamma_g2_neg
        self.delta_g2_neg = delta_g2_neg
        self.gamma_abc_g1 = gamma_abc_g1


class Groth16VerifierGadget:
    """constraints.rs:131-303 for an inner curve whose base field is the
    native constraint field: BLS12-377 (inside BW6-761 circuits) or
    MNT4-298 (inside MNT6-298 circuits — the reference's own cycle
    test, constraints.rs:452-589)."""

    def __init__(self, cs, inner_curve: str):
        self.cs = cs
        self.c = get_curve(inner_curve)
        if self.c.family == "bls12":
            self.e = BlsPairingVar(cs, inner_curve)
        elif self.c.family == "mnt4":
            from groth16_tpu_torch.gadgets.pairing_var import TatePairingVar

            self.e = TatePairingVar(cs, inner_curve)
        else:
            raise NotImplementedError(
                f"no in-circuit pairing for family {self.c.family}"
            )
        self.b3 = 3 * self.c.b % self.c.p
        self.a_coeff = self.c.a % self.c.p

    # -- prepare (constraints.rs:61-76) -------------------------------------

    def prepare(self, vk: VerifyingKeyVar) -> PreparedVerifyingKeyVar:
        alpha_beta = self.e.final_exp(
            self.e.miller_loop(vk.alpha_g1, vk.beta_g2)
        )
        return PreparedVerifyingKeyVar(
            alpha_g1_beta_g2=alpha_beta,
            gamma_g2_neg=_neg_g2(vk.gamma_g2),
            delta_g2_neg=_neg_g2(vk.delta_g2),
            gamma_abc_g1=vk.gamma_abc_g1,
        )

    # -- input accumulation (constraints.rs:255-271) --------------------------

    def prepare_inputs(self, pvk: PreparedVerifyingKeyVar,
                       input_bits: Sequence[List[Boolean]]):
        cs = self.cs
        assert len(input_bits) + 1 == len(pvk.gamma_abc_g1)
        acc = G1Var.from_affine_var(
            cs, pvk.gamma_abc_g1[0][0], pvk.gamma_abc_g1[0][1], self.b3,
            self.a_coeff,
        )
        for bits, base in zip(input_bits, pvk.gamma_abc_g1[1:]):
            base_var = G1Var.from_affine_var(
                cs, base[0], base[1], self.b3, self.a_coeff
            )
            acc = acc.add(base_var.scalar_mul_le(bits))
        return acc.to_affine()

    # -- verification (constraints.rs:247-303) --------------------------------

    def verify_with_processed_vk(self, pvk: PreparedVerifyingKeyVar,
                                 input_bits, proof: ProofVar) -> None:
        """Enforces the Groth16 equation in-circuit:
        e(A,B) e(g_ic, -gamma) e(C, -delta) == e(alpha, beta)."""
        e = self.e
        g_ic = self.prepare_inputs(pvk, input_bits)
        f = e.k12.mul(
            e.miller_loop(proof.a, proof.b),
            e.k12.mul(
                e.miller_loop(g_ic, pvk.gamma_g2_neg),
                e.miller_loop(proof.c, pvk.delta_g2_neg),
            ),
        )
        test = e.final_exp(f)
        e.k12.enforce_equal(test, pvk.alpha_g1_beta_g2)

    def verify(self, vk: VerifyingKeyVar, input_bits, proof: ProofVar) -> None:
        """The unprepared entry (constraints.rs:294-303)."""
        self.verify_with_processed_vk(self.prepare(vk), input_bits, proof)


def allocate_input_bits(cs, public_inputs: Optional[List[int]],
                        num_inputs: int, scalar_bits: int):
    """BooleanInputVar analog (constraints.rs:151): little-endian bit
    witnesses per public input."""
    out = []
    for i in range(num_inputs):
        v = None if public_inputs is None else public_inputs[i]
        out.append(bits_of(cs, v, scalar_bits))
    return out
