"""Sponge absorption of protocol structs (Fiat-Shamir transcript support).

Re-implements the behavior the reference derives from
`ark-crypto-primitives`' `Absorb` on VerifyingKey
(arkworks-rs/groth16 src/data_structures.rs:58-83, SURVEY.md §2.2 "SNARK
trait layer" row): a canonical flattening of the verifying key into base-
field elements (`to_sponge_field_elements`) and bytes
(`to_sponge_bytes`), so recursive/aggregation layers can hash the VK into
a transcript deterministically.

Conventions (matching arkworks' affine-point Absorb impl):
- An affine point absorbs as (x, y) base-field elements; the point at
  infinity absorbs as (0, 0).
- An Fp2 element absorbs as (c0, c1).
- Field elements absorb in little-endian canonical byte form for the
  byte variant.
- VerifyingKey absorbs alpha_g1, beta_g2, gamma_g2, delta_g2, then each
  gamma_abc_g1 entry in order (struct field order, data_structures.rs:32-44).
"""

from __future__ import annotations

from typing import List

from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.protocol.data_structures import Proof, VerifyingKey


def _g1_elements(pt) -> List[int]:
    if pt is None:
        return [0, 0]
    return [pt[0], pt[1]]


def _g2_elements(pt) -> List[int]:
    if pt is None:
        return [0, 0, 0, 0]
    if isinstance(pt[0], int):  # bw6-family: G2 coordinates are plain Fq
        return [pt[0], pt[1]]
    (x0, x1), (y0, y1) = pt
    return [x0, x1, y0, y1]


def vk_to_field_elements(vk: VerifyingKey) -> List[int]:
    """Base-field (Fq) element transcript of the VK."""
    out: List[int] = []
    out += _g1_elements(vk.alpha_g1)
    out += _g2_elements(vk.beta_g2)
    out += _g2_elements(vk.gamma_g2)
    out += _g2_elements(vk.delta_g2)
    for p in vk.gamma_abc_g1:
        out += _g1_elements(p)
    return out


def proof_to_field_elements(proof: Proof) -> List[int]:
    return (
        _g1_elements(proof.a)
        + _g2_elements(proof.b)
        + _g1_elements(proof.c)
    )


def vk_to_sponge_bytes(vk: VerifyingKey) -> bytes:
    """Little-endian canonical byte transcript (ceil(|Fq|/8) per elem)."""
    c = get_curve(vk.curve)
    nbytes = (c.p.bit_length() + 7) // 8
    return b"".join(
        (v % c.p).to_bytes(nbytes, "little") for v in vk_to_field_elements(vk)
    )


def vk_hash(vk: VerifyingKey) -> bytes:
    """A stable 32-byte digest of the VK (SHA-256 of the sponge bytes) —
    convenient key-identity check for key management / checkpointing."""
    import hashlib

    return hashlib.sha256(vk_to_sponge_bytes(vk)).digest()
