"""Port prover (TorchProver on the CPU, i.e. every kernel's plain
version) against the JAX package's exact prover: the same key,
assignment, r and s give the same proof, coordinate for coordinate; the
proof verifies under both packages' verifiers and fails with a wrong
public input.  Also: the key carried over from the JAX package's
upload_proving_key equals the port's own upload, digit for digit."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import prepare_verifying_key as jprepare
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol import verify_proof as jverify
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.config import resolve_device
from groth16_tpu_torch.protocol.device_keys import (
    LEAF_FIELDS,
    STATIC_FIELDS,
    device_key_from_numpy,
    proving_key_from_reference,
    upload_proving_key,
)
from groth16_tpu_torch.protocol.prover_torch import (
    TorchProver,
    msm_g1_phase,
    msm_g2_phase,
    witness_phase,
)
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import DummyCircuit, MySillyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

torch.set_num_threads(1)


def _synth(circuit, modulus):
    cs = ConstraintSystem(modulus, mode=SynthesisMode.PROVE)
    circuit(cs)
    assert cs.is_satisfied()
    return cs


def _check(curve, jpk, jvk, jcircuit, circuit, public, r, s):
    c = get_curve(curve)
    expect = create_proof_with_reduction(jcircuit, jpk, r, s)
    pk = proving_key_from_reference(jpk)
    cs = _synth(circuit, c.r)
    prover = TorchProver(pk, cs.to_matrices(), device="cpu")
    got = prover.prove(cs.full_assignment(), r, s)
    assert (got.curve, got.a, got.b, got.c) == (expect.curve, expect.a, expect.b, expect.c)
    pvk = prepare_verifying_key(pk.vk)
    assert verify_proof(pvk, got, [public])
    assert not verify_proof(pvk, got, [(public + 1) % c.r])
    jpvk = jprepare(jvk)
    assert jverify(jpvk, JProof(curve=got.curve, a=got.a, b=got.b, c=got.c), [public])
    return prover


def test_prover_silly_bn254():
    """One device pass (witness map and MSMs), assembled with random r, s
    and with r = s = 0 (the no-zk path): both equal the exact prover's."""
    curve = "bn254"
    c = get_curve(curve)
    rng = JRng(5)
    jpk, jvk = jsetup(JSilly(), curve, rng)
    a, b = rng.field_element(c.r), rng.field_element(c.r)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    pk = proving_key_from_reference(jpk)
    cs = _synth(MySillyCircuit(a=a, b=b), c.r)
    prover = TorchProver(pk, cs.to_matrices(), device="cpu")
    scalars_g, rho = witness_phase(prover.dpk, prover.encode_assignment(cs.full_assignment()))
    acc4, b2 = msm_g1_phase(prover.dpk, scalars_g), msm_g2_phase(prover.dpk, rho)
    pvk = prepare_verifying_key(pk.vk)
    for rr, ss in ((r, s), (0, 0)):
        got = prover._assemble(acc4, b2, rr, ss)
        expect = create_proof_with_reduction(JSilly(a=a, b=b), jpk, rr, ss)
        assert (got.curve, got.a, got.b, got.c) == (expect.curve, expect.a, expect.b, expect.c)
        assert verify_proof(pvk, got, [a * b % c.r])
        assert not verify_proof(pvk, got, [(a * b + 1) % c.r])
        assert jverify(jprepare(jvk), JProof(curve=got.curve, a=got.a, b=got.b, c=got.c), [a * b % c.r])


NCON, NVAR = (1 << 6) - 2, 1 << 5


@functools.lru_cache(maxsize=None)
def _dummy_setup(curve):
    """The exact setup of the 2^6 DummyCircuit and an (r, s) from the same
    Rng, made once per curve for this module's tests."""
    c = get_curve(curve)
    rng = JRng(0x2B6)
    jpk, jvk = jsetup(JDummy(NVAR, NCON), curve, rng)
    return jpk, jvk, rng.field_element(c.r), rng.field_element(c.r)


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_prover_dummy_2p6(curve):
    jpk, jvk, r, s = _dummy_setup(curve)
    _check(curve, jpk, jvk, JDummy(NVAR, NCON, a=3, b=5), DummyCircuit(NVAR, NCON, a=3, b=5), 15, r, s)


def test_device_key_carried_over_from_jax():
    from groth16_tpu.protocol.device_keys import upload_proving_key as jupload

    curve = "bn254"
    c = get_curve(curve)
    ncon, nvar = NCON, NVAR
    jpk = _dummy_setup(curve)[0]
    cs = _synth(DummyCircuit(nvar, ncon, a=3, b=5), c.r)
    jdpk = jupload(jpk, cs.to_matrices())
    leaves = {f: getattr(jdpk, f) for f in LEAF_FIELDS}
    leaves["mats"] = {k: dataclasses.asdict(m) for k, m in jdpk.mats.items()}
    leaves = {
        f: (v if f == "mats" else jax_tree_to_numpy(v)) for f, v in leaves.items()
    }
    leaves["mats"] = {
        k: {f: (np.asarray(x) if f != "num_rows" else x) for f, x in m.items()}
        for k, m in leaves["mats"].items()
    }
    static = {f: getattr(jdpk, f) for f in STATIC_FIELDS}
    got = device_key_from_numpy(leaves, static, device="cpu")
    own = upload_proving_key(proving_key_from_reference(jpk), cs.to_matrices(), device="cpu")
    for f in LEAF_FIELDS + STATIC_FIELDS:
        _assert_same(getattr(got, f), getattr(own, f), f)


def jax_tree_to_numpy(x):
    if isinstance(x, (tuple, list)):
        return tuple(jax_tree_to_numpy(v) for v in x)
    return np.asarray(x)


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (tuple, list)) and a and isinstance(a[0], torch.Tensor | tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    else:
        assert a == b, where


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """The default device is the card; without one it raises, and only
    an explicit device="cpu" runs the plain versions."""
    from groth16_tpu_torch.protocol.generator_torch import setup_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        TorchProver(None, None)  # raises before it reads the key
    with pytest.raises(RuntimeError):
        setup_device(None, "bn254", None)  # raises before it synthesizes
    assert resolve_device("cpu").type == "cpu"
