"""The port's device setup (protocol/generator_torch.py) and its pieces on
the CPU -- every kernel's plain version -- against the JAX package:

- fp.pow_const, fp.inv, fp.batch_inv, FpOps / Fp2Ops.batch_inv and
  CurveDevice.to_affine against exact integers (its exact engine,
  `groth16_tpu.ref`, for the extension field and the points), with zero
  entries and infinity (values are compared mod p, points after conversion
  to affine: representatives may differ within < 2p);
- the fixed-base window table and batch mul at c = 4, the device instance
  map and the setup's key scalars (both branches: device and host QAP)
  against its exact engine (its own tests/test_generator_device_qap.py ties
  its device versions to the same);
- setup_device against its exact setup (`groth16_tpu.protocol.generator`)
  element for element, and against its setup_device by a digest of that
  key; then a proof with the key verifies and fails with a wrong input.

Its device functions compile for seconds to a minute each on the CPU, so
none is called here (the budget: tests/test_gadget.py starts after this
file; see ROADMAP.md)."""

import functools
import hashlib
import random

import numpy as np
import pytest
import torch

from groth16_tpu.curves.params import get_curve as jget_curve
from groth16_tpu.protocol.generator import setup as jsetup
from groth16_tpu.qap.reduction import LibsnarkReduction as JReduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.r1cs.system import ConstraintSystem as JCS
from groth16_tpu.r1cs.system import SynthesisMode as JMode
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.domain import RefDomain
from groth16_tpu.ref.group import FpCtx, g2_field_ctx
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import decode, encode, make_spec
from groth16_tpu_torch.msm.fixed_base import batch_mul_device, build_window_table, window_bases
from groth16_tpu_torch.ntt.ntt import NttDomain, powers
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.generator_torch import _device_setup_scalars, _host_setup_scalars, setup_device
from groth16_tpu_torch.protocol.prover import create_proof_with_reduction_and_matrices
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.qap.device import (
    encode_matrix_transposed,
    instance_map_device,
    lagrange_coeffs_device,
)
from groth16_tpu_torch.qap.reduction import LibsnarkReduction
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
from groth16_tpu_torch.utils.rng import Rng

torch.set_num_threads(1)
CPU = torch.device("cpu")
NV, NC = 6, 13  # tests/test_generator_device_qap.py's end-to-end circuit


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def _vals(spec, arr):
    """Montgomery digits (any class) -> ints mod p."""
    return decode(np.asarray(arr).astype(np.int64), spec)


@pytest.mark.parametrize("field", ["Fr"])
def test_pow_inv_batch_inv(field):
    """bn254 Fr (the bls12_381 digits of K1 against the JAX package:
    test_torch_fp.py)."""
    modulus = get_curve("bn254").r
    s = make_spec(modulus)
    r = random.Random(5)
    vals = [r.randrange(modulus) for _ in range(5)] + [0, 1, modulus - 1]
    a = _t(encode(vals, s))
    for e in (0, 1, r.randrange(1 << 64)):
        assert _vals(s, fp.pow_const(s, a, e)) == [pow(v, e, modulus) for v in vals]
    assert _vals(s, fp.inv(s, a)) == [pow(v, modulus - 2, modulus) for v in vals]
    # 8 entries: one chunk; 70: two chunks of the two-level scan, padded
    for n in (8, 70):
        vals += [r.randrange(1, modulus) for _ in range(n - len(vals))]
        got = fp.batch_inv(s, _t(encode(vals, s)))
        assert _vals(s, got) == [pow(v, modulus - 2, modulus) for v in vals]


def _points(ref, g2, n, r):
    base, mul = (ref.g2_sample(1), ref.g2_mul) if g2 else (ref.g1_sample(5), ref.g1_mul)
    return [mul(base, r.randrange(1, ref.c.r)) for _ in range(n)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ops_batch_inv_and_to_affine(group):
    """bn254 (the codec runs this conversion on bls12_381 points in
    test_torch_curve.py and test_torch_msm.py)."""
    curve = "bn254"
    c = get_curve(curve)
    g2 = group == "g2"
    g = (codec.g2_ops if g2 else codec.g1_ops)(c)
    k, s = g.k, g.k.spec
    ctx = g2_field_ctx(jget_curve(curve)) if g2 else FpCtx(c.p)
    r = random.Random(7)
    # the ops' batch inversion, with a zero (0 or (0, 0)) entry
    vals = [r.randrange(c.p) for _ in range(16 if g2 else 8)]
    digits = encode(vals, s).reshape((s.n_limbs, 2, 8) if g2 else (s.n_limbs, 8))
    digits[..., 3] = 0
    got = _vals(s, np.moveaxis(k.batch_inv(_t(digits)).numpy(), 1, 2) if g2 else k.batch_inv(_t(digits)))
    elems = list(zip(vals[:8], vals[8:])) if g2 else vals
    elems[3] = ctx.zero()
    want = [ctx.zero() if ctx.is_zero(x) else ctx.inv(x) for x in elems]
    assert (list(zip(got[0::2], got[1::2])) if g2 else got) == want
    # to_affine of projective points with Z != 1, and infinity
    pts = _points(RefGroups(curve), g2, 6, r) + [None]
    p = (codec.g2_to_device if g2 else codec.g1_to_device)(c, pts, "cpu")
    p = g.add(p, g.infinity(g.batch_shape(p)))  # P + inf: Z != 1
    assert (codec.g2_from_device if g2 else codec.g1_from_device)(c, g, p) == pts
    # a single point (batch shape ()): one Fermat inverse, no scan
    x, y, inf = g.to_affine(tuple(t[..., 0] for t in p))
    coeffs = (lambda v: list(v)) if g2 else (lambda v: [v])
    assert not bool(inf)
    assert (_vals(s, x), _vals(s, y)) == (coeffs(pts[0][0]), coeffs(pts[0][1]))


def test_window_table_and_batch_mul():
    curve = "bn254"
    c = get_curve(curve)
    ref = RefGroups(curve)
    cw, bits = 4, c.r.bit_length()
    W = -(-bits // cw)
    B = 1 << cw
    g = codec.g1_ops(c)
    base = ref.g1_sample(5)
    table = build_window_table(g, codec.g1_to_device(c, window_bases(ref.g1_add, base, cw, W), "cpu"), cw)
    assert table[2].shape == (c_limbs := make_spec(c.p).n_limbs, W, B)
    r = random.Random(9)
    scalars = [0, 1, 2, c.r - 1] + [r.randrange(c.r) for _ in range(4)]
    pts = batch_mul_device(g, table, codec.scalars_to_device(scalars, make_spec(c.r), "cpu"), cw, bits)
    assert pts[0].shape == (c_limbs, len(scalars))
    # rows 0, 1 and W - 1 of the table, then the products: one decode
    rows = tuple(x[:, [0, 1, W - 1]].reshape(c_limbs, -1) for x in table)
    got = codec.g1_from_device(c, g, tuple(torch.cat([x, y], dim=1) for x, y in zip(rows, pts)))
    for i, w in enumerate((0, 1, W - 1)):
        assert got[i * B : (i + 1) * B] == [ref.g1_mul(base, d << (cw * w)) for d in range(B)]
    assert got[3 * B :] == [ref.g1_mul(base, sc) for sc in scalars]


def _fixture(curve="bn254", n_con=37, n_vars=11):
    """tests/test_generator_device_qap.py's fixture, synthesized by both
    packages."""
    c = get_curve(curve)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.SETUP)
    DummyCircuit(n_vars, n_con)(cs)
    jcs = JCS(c.r, mode=JMode.SETUP)
    JDummy(n_vars, n_con)(jcs)
    return c, cs.to_matrices(), jcs.to_matrices(), cs.num_instance_variables, cs.num_constraints


def test_lagrange_and_instance_map():
    c, m, jm, ni, nc = _fixture()
    jc = jget_curve("bn254")
    spec = make_spec(c.r, name="bn254.Fr")
    t = 0xDEADBEEF12345
    dom = NttDomain(c.fr, 64, CPU)
    got = lagrange_coeffs_device(spec, dom, t, powers(spec, dom.group_gen, 64, CPU))
    assert _vals(spec, got) == RefDomain(jc.fr, 64).evaluate_all_lagrange_coefficients(t)

    t = 0x1234567890ABCDEF11 % c.r
    nv = ni + m.num_witness_variables
    dom = NttDomain(c.fr, nc + ni, CPU)
    mats_t = {k: encode_matrix_transposed(v, spec, nv, CPU) for k, v in m.flatten().items()}
    got = instance_map_device(spec, dom, mats_t, t, ni, nc, powers(spec, dom.group_gen, dom.size, CPU))
    a, b, ce, _, qnv, _ = JReduction.instance_map_with_evaluation(jm, jc.fr, t)
    assert nv == qnv + 1
    assert [_vals(spec, x) for x in got] == [list(a), list(b), list(ce)]


def _scalar_args():
    """The fixture, and the setup's scalar arguments from
    tests/test_generator_device_qap.py's Rng(7) draws."""
    c, m, jm, ni, nc = _fixture()
    jc = jget_curve("bn254")
    spec = make_spec(c.r, name="bn254.Fr")
    r = c.r
    rng = JRng(7)
    alpha, beta, gamma, delta = (rng.nonzero_field_element(r) for _ in range(4))
    gamma_inv, delta_inv = pow(gamma, r - 2, r), pow(delta, r - 2, r)
    t = RefDomain(jc.fr, nc + ni).sample_element_outside_domain(rng)
    return c, m, jm, ni, nc, spec, t, (alpha, beta, gamma, delta, gamma_inv, delta_inv)


def _want_scalars(jm, t, ni, alpha, beta, gamma, delta, gamma_inv, delta_inv):
    """The exact engine's key scalars, (n_hint, counts, G1 list, G2 list)."""
    jc = jget_curve("bn254")
    r = jc.r
    a, b, ce, zt, qnv, m_raw = JReduction.instance_map_with_evaluation(jm, jc.fr, t)
    s = [(beta * a[i] + alpha * b[i] + ce[i]) % r for i in range(qnv + 1)]
    h = JReduction.h_query_scalars(m_raw - 1, t, zt, delta_inv, jc.fr)
    g1 = (
        list(a) + list(b) + list(h) + [x * delta_inv % r for x in s[ni:]]
        + [x * gamma_inv % r for x in s[:ni]] + [alpha, beta, delta]
    )
    counts = (len(a), len(b), len(h), qnv + 1 - ni, ni)
    return qnv + 1, counts, g1, list(b) + [beta, gamma, delta]


def test_setup_scalars():
    """Every key scalar of the device-QAP branch: the tensors hold the
    canonical standard-form digits of the exact engine's lists."""
    c, m, jm, ni, nc, spec, t, ks = _scalar_args()
    dom = NttDomain(c.fr, nc + ni, CPU)
    n_hint, counts, g1, g2 = _device_setup_scalars(c, spec, dom, m, t, *ks, ni)
    want_hint, want_counts, want_g1, want_g2 = _want_scalars(jm, t, ni, *ks)
    assert (n_hint, counts) == (want_hint, want_counts)
    np.testing.assert_array_equal(g1.numpy(), encode(want_g1, spec, mont=False).astype(np.int32))
    np.testing.assert_array_equal(g2.numpy(), encode(want_g2, spec, mont=False).astype(np.int32))


def _key_digest(pk) -> str:
    """sha256 of a proving key's fields in a fixed order (either package's
    ProvingKey: points are int tuples, None for infinity)."""
    vk = pk.vk
    fields = [vk.curve, vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, list(vk.gamma_abc_g1),
              pk.beta_g1, pk.delta_g1, list(pk.a_query), list(pk.b_g1_query), list(pk.b_g2_query),
              list(pk.h_query), list(pk.l_query)]
    return hashlib.sha256(repr(fields).encode()).hexdigest()


# _key_digest(groth16_tpu.protocol.generator_tpu.setup_device(
#     DummyCircuit(6, 13), curve, Rng(3))[0]) with the JAX package's
# DummyCircuit and Rng, on the CPU.  That call compiles for 45-100 s, which
# the suite's budget cannot hold; the JAX package is the fixed reference
# of this port, so its key does not change.
JAX_SETUP_DEVICE_DIGEST = {
    "bn254": "37f171165d2f159cee6ae31e79989e4e9ce9d0d65fbec2ad8b210dc3b9b69c90",
    "bls12_381": "4becbd6b7fad0ae46e227b62433347f25a298db9eab710278addef6c8f39a72e",
}


@functools.lru_cache(maxsize=None)
def _exact_key(curve):
    return proving_key_from_reference(jsetup(JDummy(NV, NC), curve, JRng(3))[0])


@pytest.mark.parametrize("curve", ["bn254"])  # bls12_381: test_torch_late.py
def test_setup_device_matches_jax_and_exact(curve):
    """Then the key proves: with the exact prover (TorchProver on the CPU
    takes ~15 s a proof, and test_torch_prover.py proves exact keys, which
    this one equals, with it on both curves)."""
    pk, vk = setup_device(DummyCircuit(NV, NC), curve, Rng(3), device="cpu")
    assert pk == _exact_key(curve)
    assert _key_digest(pk) == JAX_SETUP_DEVICE_DIGEST[curve]
    assert vk == pk.vk
    c = get_curve(curve)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(NV, NC, a=3, b=7)(cs)
    m = cs.to_matrices()
    proof = create_proof_with_reduction_and_matrices(
        pk, 111, 222, m, m.num_instance_variables, m.num_constraints, cs.full_assignment()
    )
    pvk = prepare_verifying_key(vk)
    assert verify_proof(pvk, proof, [21])
    assert not verify_proof(pvk, proof, [22])


def test_setup_device_host_qap_branch():
    """The host-QAP branch's key scalars (a reduction other than
    LibsnarkReduction, or a domain that is not radix-2) in the device
    branch's layout: the exact engine's lists.  The batch muls after it
    are the device branch's, which test_setup_device_matches_jax_and_exact
    holds to the exact key."""
    c, m, jm, ni, nc, spec, t, ks = _scalar_args()
    n_hint, counts, g1, g2 = _host_setup_scalars(LibsnarkReduction, c.fr, spec, m, t, *ks, ni, CPU)
    want_hint, want_counts, want_g1, want_g2 = _want_scalars(jm, t, ni, *ks)
    assert (n_hint, counts) == (want_hint, want_counts)
    np.testing.assert_array_equal(g1.numpy(), encode(want_g1, spec, mont=False).astype(np.int32))
    np.testing.assert_array_equal(g2.numpy(), encode(want_g2, spec, mont=False).astype(np.int32))
