"""Verifier (reference: src/verifier.rs).

Checks e(A,B) * e(g_ic, -gamma) * e(C, -delta) == e(alpha, beta) via one
3-pair multi-Miller loop + final exponentiation (verifier.rs:44-65), with
g_ic = gamma_abc[0] + sum_i x_i * gamma_abc[i+1] (verifier.rs:25-39).

Dispatch, as in the JAX package: the native C++ host engine
(groth16_tpu_torch.native) runs the pairing product and the g_ic
accumulation where it loads (the Fp12 tower engine for BN/BLS12, the
Tate engine for MNT4/6 and BW6; bit-identical to the Python engine,
tests/test_torch_native.py); the pure-Python exact engine runs where g++
is missing or native is disabled (GROTH16_TPU_NO_NATIVE=1).
"""

from __future__ import annotations

from typing import List

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.native import native_pairing
from groth16_tpu_torch.protocol.data_structures import (
    PreparedVerifyingKey,
    Proof,
    VerifyingKey,
)
from groth16_tpu_torch.r1cs.system import SynthesisError
from groth16_tpu_torch.ref.pairing import make_pairing


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    """verifier.rs:13-20."""
    c = get_curve(vk.curve)
    from groth16_tpu_torch.ref.group import g2_jacobian

    nat = native_pairing(vk.curve)
    if nat is not None:
        alpha_beta = nat.pairing(vk.alpha_g1, vk.beta_g2)
    else:
        alpha_beta = make_pairing(vk.curve).pairing(vk.alpha_g1, vk.beta_g2)
    g2 = g2_jacobian(c)
    return PreparedVerifyingKey(
        vk=vk,
        alpha_g1_beta_g2=alpha_beta,
        gamma_g2_neg=g2.to_affine(g2.neg(g2.from_affine(vk.gamma_g2))),
        delta_g2_neg=g2.to_affine(g2.neg(g2.from_affine(vk.delta_g2))),
    )


def prepare_inputs(pvk: PreparedVerifyingKey, public_inputs: List[int]):
    """verifier.rs:25-39."""
    if len(public_inputs) + 1 != len(pvk.vk.gamma_abc_g1):
        raise SynthesisError(SynthesisError.Kind.MALFORMED_VERIFYING_KEY)
    c = get_curve(pvk.vk.curve)
    nat = native_pairing(pvk.vk.curve)
    if nat is not None:
        return nat.g1_msm(
            pvk.vk.gamma_abc_g1, [1] + [x % c.r for x in public_inputs]
        )
    from groth16_tpu_torch.ref.group import g1_jacobian

    g1 = g1_jacobian(c)
    acc = g1.from_affine(pvk.vk.gamma_abc_g1[0])
    for x, base in zip(public_inputs, pvk.vk.gamma_abc_g1[1:]):
        acc = g1.add(acc, g1.scalar_mul(g1.from_affine(base), x % c.r))
    return g1.to_affine(acc)


def verify_proof_with_prepared_inputs(
    pvk: PreparedVerifyingKey, proof: Proof, prepared_inputs
) -> bool:
    """verifier.rs:44-65."""
    g1s = [proof.a, prepared_inputs, proof.c]
    g2s = [proof.b, pvk.gamma_g2_neg, pvk.delta_g2_neg]
    nat = native_pairing(pvk.vk.curve)
    if nat is not None:
        test = nat.multi_pairing(g1s, g2s)
        if test is None:  # Tate engine: zero Miller value (as Python)
            raise SynthesisError(SynthesisError.Kind.UNEXPECTED_IDENTITY)
        return test == pvk.alpha_g1_beta_g2
    pairing = make_pairing(pvk.vk.curve)
    qap = pairing.multi_miller_loop(g1s, g2s)
    test = pairing.final_exponentiation(qap)
    if test is None:
        raise SynthesisError(SynthesisError.Kind.UNEXPECTED_IDENTITY)
    return test == pvk.alpha_g1_beta_g2


def verify_proof(pvk: PreparedVerifyingKey, proof: Proof, public_inputs: List[int]) -> bool:
    """verifier.rs:69-76."""
    return verify_proof_with_prepared_inputs(
        pvk, proof, prepare_inputs(pvk, public_inputs)
    )
