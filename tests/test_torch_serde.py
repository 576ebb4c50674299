"""The port's copies of the pure-Python serde, absorb and resume modules
against the JAX package's:

- `groth16_tpu_torch.serde` writes the same bytes as `groth16_tpu.serde`
  for a proof, a verifying key and a prepared verifying key (compressed
  and not) on bn254 and bls12_381, the wire format's golden digests of
  `tests/test_serde.py` hold, every blob reads back, and malformed blobs
  are refused;
- `vk_hash` and the VK's field elements equal the JAX package's;
- `utils.resume.prove_batch_resumable` resumes from its checkpoints and
  re-proves only a corrupt one, with a stand-in prover built on the
  port's exact prover.

Tolerance: equal bytes and equal integers."""

import functools
import hashlib
import os

import pytest

from groth16_tpu import serde as jserde
from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import vk_hash as jvk_hash
from groth16_tpu.protocol import vk_to_field_elements as jvk_elems
from groth16_tpu.protocol.data_structures import PreparedVerifyingKey as JPvk
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.data_structures import VerifyingKey as JVk
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch import serde
from groth16_tpu_torch.protocol import (
    Proof,
    VerifyingKey,
    prepare_verifying_key,
    setup,
    vk_hash,
    vk_to_field_elements,
)
from groth16_tpu_torch.protocol.prover import create_proof_with_reduction_and_matrices
from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
from groth16_tpu_torch.serde.canonical import SerializationError
from groth16_tpu_torch.utils.resume import prove_batch_resumable
from groth16_tpu_torch.utils.rng import Rng

# (compressed proof, uncompressed proof, compressed vk): length and
# sha256[:16], from tests/test_serde.py
GOLDEN = {
    "bn254": (128, "98887a5ad2ceb1ec", 256, "b915d038a84ee242", 328, "b19d6d53bb2b621b"),
}


@functools.lru_cache(maxsize=None)
def _fixture(name):
    """tests/test_serde.py's proof and vk, as the port's dataclasses."""
    g = RefGroups(name)
    P = g.g1_sample(3)
    Q = g.g2_sample(1)
    proof = Proof(curve=name, a=P, b=Q, c=g.g1_mul(P, 7))
    vk = VerifyingKey(
        curve=name, alpha_g1=P, beta_g2=Q, gamma_g2=g.g2_mul(Q, 3), delta_g2=g.g2_mul(Q, 5),
        gamma_abc_g1=[P, g.g1_mul(P, 2), None],
    )
    return proof, vk


def _jax(obj):
    """The JAX package's dataclass with the same fields."""
    cls = {Proof: JProof, VerifyingKey: JVk}[type(obj)]
    return cls(**vars(obj))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_proof_and_vk_bytes_equal_the_jax_package(name, compress):
    proof, vk = _fixture(name)
    pb = serde.serialize_proof(proof, compress)
    vb = serde.serialize_verifying_key(vk, compress)
    assert pb == jserde.serialize_proof(_jax(proof), compress)
    assert vb == jserde.serialize_verifying_key(_jax(vk), compress)
    assert serde.deserialize_proof(pb, name, compress) == proof
    assert serde.deserialize_verifying_key(vb, name, compress) == vk
    if name in GOLDEN:
        lc, hc, lu, hu, lv, hv = GOLDEN[name]
        length, digest = (lc, hc) if compress else (lu, hu)
        assert (len(pb), hashlib.sha256(pb).hexdigest()[:16]) == (length, digest)
        if compress:
            assert (len(vb), hashlib.sha256(vb).hexdigest()[:16]) == (lv, hv)


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_pvk_bytes_equal_the_jax_package(name):
    _, vk = _fixture(name)
    pvk = prepare_verifying_key(vk)
    jpvk = JPvk(vk=_jax(vk), alpha_g1_beta_g2=pvk.alpha_g1_beta_g2, gamma_g2_neg=pvk.gamma_g2_neg,
                delta_g2_neg=pvk.delta_g2_neg)
    data = serde.serialize_prepared_verifying_key(pvk)
    assert data == jserde.serialize_prepared_verifying_key(jpvk)
    got = serde.deserialize_prepared_verifying_key(data, name)
    assert (got.vk, got.alpha_g1_beta_g2, got.gamma_g2_neg, got.delta_g2_neg) == (
        vk, pvk.alpha_g1_beta_g2, pvk.gamma_g2_neg, pvk.delta_g2_neg)
    with pytest.raises(SerializationError):
        serde.deserialize_prepared_verifying_key(data + b"\x00", name)


def test_rejects_bad_points():
    name = "bn254"
    proof, _ = _fixture(name)
    c = get_curve(name)
    from groth16_tpu_torch.ref.field import legendre

    nb = (c.p.bit_length() + 7) // 8
    blob = serde.serialize_proof(proof, True)
    x_bad = next(x for x in range(1, 100) if legendre(x**3 + c.b, c.p) == -1)
    for bad in (
        x_bad.to_bytes(nb, "little") + blob[nb:],  # no point with this x
        (c.p + 1).to_bytes(nb, "little") + blob[nb:],  # a coordinate >= p
        blob + b"\x00",  # trailing bytes
    ):
        with pytest.raises(SerializationError):
            serde.deserialize_proof(bad, name, True)


@pytest.mark.parametrize("name", ["bn254", "bls12_381"])
def test_vk_hash_equals_the_jax_package(name):
    _, vk = _fixture(name)
    assert vk_to_field_elements(vk) == jvk_elems(_jax(vk))
    assert vk_hash(vk) == jvk_hash(_jax(vk))
    again = serde.deserialize_verifying_key(serde.serialize_verifying_key(vk, True), name, True)
    assert vk_hash(again) == vk_hash(vk)


class _ExactProver:
    """A stand-in for TorchProver: .prove on the port's exact prover,
    counting its calls."""

    def __init__(self, pk, cs):
        self.pk, self.cs, self.calls = pk, cs, 0

    def prove(self, z, r, s):
        self.calls += 1
        cs = self.cs
        return create_proof_with_reduction_and_matrices(
            self.pk, r, s, cs.to_matrices(), cs.num_instance_variables, cs.num_constraints, z)


def test_prove_batch_resumable(tmp_path):
    """Checkpointed batch: a second run resumes every proof from its
    checkpoint (the prover is not called); a corrupt checkpoint is
    re-proved, and only that one.  The checkpoints are the JAX package's
    bytes for the same proofs."""
    curve = "bn254"
    c = get_curve(curve)
    rng = Rng(0xC4)
    pk, vk = setup(MySillyCircuit(), curve, rng)
    cases = [(3, 5), (7, 11)]
    zs, pubs = [], []
    for a, b in cases:
        cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
        MySillyCircuit(a=a, b=b)(cs)
        zs.append(cs.full_assignment())
        pubs.append([a * b % c.r])
    rs = [rng.field_element(c.r) for _ in cases]
    ss = [rng.field_element(c.r) for _ in cases]
    ckpt = str(tmp_path / "ckpt")
    prover = _ExactProver(pk, cs)
    proofs = prove_batch_resumable(prover, vk, zs, pubs, rs, ss, ckpt)
    assert prover.calls == 2
    for i, proof in enumerate(proofs):
        with open(os.path.join(ckpt, f"proof_{i:06d}.bin"), "rb") as f:
            assert f.read() == jserde.serialize_proof(_jax(proof), compress=True)

    class Boom:
        def prove(self, *a):
            raise AssertionError("should have resumed from checkpoints")

    assert prove_batch_resumable(Boom(), vk, zs, pubs, rs, ss, ckpt) == proofs
    with open(os.path.join(ckpt, "proof_000000.bin"), "wb") as f:
        f.write(b"garbage")
    prover.calls = 0
    assert prove_batch_resumable(prover, vk, zs, pubs, rs, ss, ckpt) == proofs
    assert prover.calls == 1
