"""In-circuit Absorb / ToBytes gadgets for the Groth16 structs.

Mirrors the reference's `AbsorbGadget` impl on VerifyingKeyVar
(arkworks-rs/groth16 src/constraints.rs:78-110) and `ToBytesGadget`
(:432-450): a canonical flattening of the verifying key (and proof)
into base-field variables / byte variables, matching the HOST-side
transcript conventions in groth16_tpu/protocol/absorb.py exactly —
so an in-circuit sponge sees the same element stream a native
Fiat-Shamir transcript hashes.

Conventions (identical to protocol/absorb.py):
- affine G1 absorbs as (x, y); G2 as (x0, x1, y0, y1) coordinate vars;
- VK order: alpha_g1, beta_g2, gamma_g2, delta_g2, then gamma_abc_g1;
- bytes = little-endian canonical bytes per field element
  (`to_bytes_le`, which enforces the canonical bit decomposition).
"""

from __future__ import annotations

from typing import List

from groth16_tpu_torch.gadgets.groth16_var import ProofVar, VerifyingKeyVar
from groth16_tpu_torch.gadgets.r1cs_std import FpVar, to_bytes_le


def _g1_vars(pt) -> List[FpVar]:
    return [pt[0], pt[1]]


def _g2_vars(pt) -> List[FpVar]:
    (x0, x1), (y0, y1) = pt
    return [x0, x1, y0, y1]


def vk_to_sponge_field_elements_var(vk: VerifyingKeyVar) -> List[FpVar]:
    """AbsorbGadget::to_sponge_field_elements (constraints.rs:97-110);
    free — no constraints (the vars are already field elements)."""
    out: List[FpVar] = []
    out += _g1_vars(vk.alpha_g1)
    out += _g2_vars(vk.beta_g2)
    out += _g2_vars(vk.gamma_g2)
    out += _g2_vars(vk.delta_g2)
    for p in vk.gamma_abc_g1:
        out += _g1_vars(p)
    return out


def vk_to_sponge_bytes_var(vk: VerifyingKeyVar) -> List[FpVar]:
    """AbsorbGadget::to_sponge_bytes (constraints.rs:85-95): canonical
    little-endian bytes of every element, concatenated."""
    out: List[FpVar] = []
    for el in vk_to_sponge_field_elements_var(vk):
        out += to_bytes_le(el)
    return out


# ToBytesGadget::to_bytes_le on VerifyingKeyVar (constraints.rs:432-450)
# uses the same element order and byte encoding as the sponge bytes.
vk_to_bytes_le_var = vk_to_sponge_bytes_var


def proof_to_field_elements_var(proof: ProofVar) -> List[FpVar]:
    return _g1_vars(proof.a) + _g2_vars(proof.b) + _g1_vars(proof.c)


def proof_to_bytes_le_var(proof: ProofVar) -> List[FpVar]:
    out: List[FpVar] = []
    for el in proof_to_field_elements_var(proof):
        out += to_bytes_le(el)
    return out
