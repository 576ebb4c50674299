"""BW6-761 in the port on the CPU (every kernel's plain version, L = 52
digits for its 761-bit Fq, L = 26 for its 377-bit Fr).

- Field engine and libraries: the plain K1 at L = 52 digit-equal to the
  JAX package's fp.mont_mul on exact, semi and lazy digits; the word
  engine's steps at L = 52 (tests/test_torch_fp.py's model: 24 words, 24
  full steps and a 12-bit one) give the plain version's digits;
  `curve_variants` builds BW6-761's four L = 52 libraries over Fq and
  its Horner library, none over Fq2 (and MNT6-298's K1, Horner, the
  generic-a group kernel and the scalar multiplication's generic-a
  libraries).
- Points: G1 and G2 (both over Fq, each with its own b3) full and mixed
  additions give the exact engine's sums (P + P, P + (-P) and infinity
  lanes included), and K6's word steps (tests/test_torch_k6.py's
  WordModel) give the plain mixed addition's digits for both b3's.
- Prove: the gadget circuit (groth16_tpu_torch.r1cs.gadget_circuit: a
  BLS12-377 G1 addition in-circuit, its x public), built from the port's
  gadgets and from the JAX package's, has the same constraint system;
  TorchProver on the CPU proves it with BW6-761 from the port's exact
  setup, and the proof equals the JAX package's exact prover's on the
  same key, r and s, verifies under both packages' verifiers and fails
  with a wrong public input.

Three cases, ~45 s in all, most of it the prove (the plain L = 52
products), the exact setup and prover, and the JAX package's BW6-761
parameters (~7 s to derive once a process): pytest-xdist's --dist
loadfile hands a file of three cases out after tests/test_gadget.py.
Tolerance: exact (digits and points are integers)."""

import random

import jax
import numpy as np
import torch
from test_torch_fp import _at_limit, _digits, _vals, _value, _words_model
from test_torch_k6 import WordModel, _plus_p

from groth16_tpu.curves.params import get_curve
from groth16_tpu.fields import fp as jfp
from groth16_tpu.fields.spec import make_spec as jmake_spec
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu_torch.curves import codec, cuda_point
from groth16_tpu_torch.curves.params import get_curve as tget_curve
from groth16_tpu_torch.fields import cuda_fp, fp
from groth16_tpu_torch.fields.spec import LIMB_BITS, make_spec
from groth16_tpu_torch.utils.cuda_build import curve_variants

torch.set_num_threads(1)

CURVE = "bw6_761"


def _ints(x):
    """[L, n] digits -> n Python ints."""
    return [sum(int(d) << (LIMB_BITS * j) for j, d in enumerate(col)) for col in x.T.tolist()]


def _affine(spec, pt):
    """Projective Montgomery-form points -> affine int pairs (None at
    infinity), on the host: the device decode's Fermat inverse runs
    ~1,500 plain 761-bit products."""
    p, rinv = spec.modulus, pow(spec.R, -1, spec.modulus)
    out = []
    for X, Y, Z in zip(*(_ints(c) for c in pt)):
        X, Y, Z = (v * rinv % p for v in (X, Y, Z))
        if Z == 0:
            out.append(None)
        else:
            zi = pow(Z, -1, p)
            out.append((X * zi % p, Y * zi % p))
    return out


def test_bw6_field_engine_and_libraries():
    p = get_curve(CURVE).p
    s, js = make_spec(p), jmake_spec(p)
    L = s.n_limbs
    assert L == 52 and cuda_fp.KERNEL_WORDS[L] == 24 and 8 * p < 1 << (32 * 24)
    rinv = pow(s.R, -1, p)
    for cls in ("exact", "semi", "lazy"):
        a, b = _digits(_vals(p, 1), s, cls, 3), _digits(_vals(p, 2), s, cls, 4)
        got = fp.mont_mul(s, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
        want = np.asarray(jax.jit(lambda x, y: jfp.mont_mul(js, x, y))(a, b))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        assert [v % p for v in _value(got.numpy())] == [
            x * y * rinv % p for x, y in zip(_vals(p, 1), _vals(p, 2))]
    # K1's word steps at L = 52 (tests/test_torch_fp.py's model)
    r = random.Random(13)
    va = [0, 1, p - 1, 8 * p - 1, 8 * p - 2] + [r.randrange(8 * p) for _ in range(32)]
    vb = [8 * p - 1, p - 1, 1, 8 * p - 1, 8 * p - 3] + [r.randrange(8 * p) for _ in range(32)]
    a = np.concatenate([_at_limit(va[:5], L), _digits(va[5:], s, "lazy", 14)], axis=1)
    b = np.concatenate([_at_limit(vb[:5], L), _digits(vb[5:], s, "lazy", 15)], axis=1)
    plain = cuda_fp.mont_mul_plain(s, torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32)))
    assert [_words_model((a[:, i], b[:, i]), p, L) for i in range(a.shape[1])] == plain.numpy().T.tolist()
    # the libraries its prove and setup load: L = 52 over Fq, none over Fq2
    assert curve_variants(tget_curve(CURVE)) == [
        "mont_mul", "horner_L52", "point_add_L52_d1_full_nr0", "point_add_L52_d1_mixed_nr0",
        "suffix_scan_L52_d1_nr0"]
    assert curve_variants(tget_curve("bls12_377")) == [
        "mont_mul", "horner_L26", "point_add_L26_d1_full_nr0", "point_add_L26_d1_mixed_nr0",
        "point_add_L26_d2_full_nrm5", "point_add_L26_d2_mixed_nrm5", "suffix_scan_L26_d1_nr0",
        "suffix_scan_L26_d2_nrm5"]
    # a != 0 (MNT): K1, Horner (and the scalar multiplication) and the
    # generic-a group kernel over Fq and G2's Fq3
    assert curve_variants(tget_curve("mnt6_298")) == [
        "mont_mul", "horner_L21", "general_add_L21_d1_nr0", "general_add_L21_d3_nr5"]


def test_bw6_point_additions_and_k6_words():
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    for is_g2 in (False, True):
        _group_additions(c, ref, is_g2)


def _group_additions(c, ref, is_g2):
    """G1's or G2's full and mixed additions against the exact engine,
    and K6's word steps against the plain mixed addition."""
    add = ref.g2_add if is_g2 else ref.g1_add
    base = ref.g2_sample(1) if is_g2 else ref.g1_sample(5)
    pts, cur = [], base
    for _ in range(5):
        pts.append(cur)
        cur = add(add(cur, cur), base)  # 3k + 1 multiples: distinct, no small relations
    lhs = pts[:4] + [pts[0], pts[1], pts[4], None, None]
    rhs = pts[::-1][:4] + [pts[0], (ref.g2_neg if is_g2 else ref.g1_neg)(pts[1]), None, pts[3], None]
    want = [add(a, b) for a, b in zip(lhs, rhs)]
    g = (codec.g2_ops if is_g2 else codec.g1_ops)(c)
    to_dev = codec.g2_to_device if is_g2 else codec.g1_to_device
    assert g.k.tower_deg == 1 and g.k.spec.n_limbs == 52
    A = to_dev(c, lhs, "cpu")
    assert _affine(g.k.spec, g.add(A, to_dev(c, rhs, "cpu"))) == want
    X, Y, _ = to_dev(c, rhs, "cpu")
    inf2 = torch.tensor([q is None for q in rhs])
    xy = tuple(torch.where(inf2, torch.zeros_like(v), v) for v in (X, Y))
    assert _affine(g.k.spec, g.add_affine(A, xy)) == want

    # K6's word steps at L = 52 on projective P1 (Z != 1) and the
    # representatives in [p, 2p), with this group's b3
    p1 = g.add(A, g.infinity(g.batch_shape(A)))
    p1 = tuple(_plus_p(x, c.p, torch.zeros_like(inf2)) for x in p1)
    xy = tuple(_plus_p(x, c.p, inf2) for x in xy)
    plain = cuda_point.mixed_add_plain(cuda_point._plain_ops(g.k.spec, None), g.b3_val, p1, xy)
    model = WordModel(g.k.spec, g.b3_val)
    assert (model.W, model.full, model.part) == (24, 24, 12)
    for i in range(len(lhs)):
        assert model.add_mixed(*(x[:, i].tolist() for x in p1 + xy)) == [x[:, i].tolist() for x in plain], i
    assert _affine(g.k.spec, plain) == want


def _jax_circuit(P=None, Q=None):
    """gadget_circuit.G1AddCircuit built from the JAX package's gadgets."""
    from groth16_tpu.gadgets.curve_var import G1Var
    from groth16_tpu.gadgets.r1cs_std import FpVar

    def synth(cs):
        b3 = 3 * get_curve("bls12_377").b

        def point(pt):
            x = FpVar.new_witness(cs, None if pt is None else pt[0])
            y = FpVar.new_witness(cs, None if pt is None else pt[1])
            return G1Var.from_affine_var(cs, x, y, b3)

        x, _ = point(P).add(point(Q)).to_affine()
        FpVar.new_input(cs, x.value).enforce_equal(x)

    return synth


def test_bw6_gadget_circuit_prove_matches_exact():
    from groth16_tpu.protocol import prepare_verifying_key as jprepare
    from groth16_tpu.protocol import verify_proof as jverify
    from groth16_tpu.protocol.data_structures import Proof as JProof
    from groth16_tpu.protocol.prover import create_proof_with_reduction
    from groth16_tpu.r1cs.system import ConstraintSystem as JCS
    from groth16_tpu.r1cs.system import SynthesisMode as JMode
    from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.gadget_circuit import G1AddCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(CURVE)
    inner = RefGroups("bls12_377")
    P = inner.g1_sample(3)
    Q = inner.g1_mul(P, 0xC0FFEE)
    x_sum = inner.g1_add(P, Q)[0]
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    G1AddCircuit(P, Q)(cs)
    jcs = JCS(c.r, mode=JMode.PROVE)
    _jax_circuit(P, Q)(jcs)
    assert cs.is_satisfied() and jcs.is_satisfied()
    m, jm = cs.to_matrices(), jcs.to_matrices()
    assert (m.num_instance_variables, m.num_witness_variables, m.a, m.b, m.c) == (
        jm.num_instance_variables, jm.num_witness_variables, jm.a, jm.b, jm.c)
    assert cs.full_assignment() == jcs.full_assignment()
    assert cs.full_assignment()[1] == x_sum

    # the port's exact setup (the JAX package's code, its inverses by
    # extended Euclid); the JAX package's exact prover reads the same key
    rng = Rng(0xB6)
    ref_pk, vk = setup(G1AddCircuit(), CURVE, rng)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    want = create_proof_with_reduction(_jax_circuit(P, Q), ref_pk, r, s)
    pk = proving_key_from_reference(ref_pk)
    prover = TorchProver(pk, m, device="cpu")
    got = prover.prove(cs.full_assignment(), r, s)
    assert (got.curve, got.a, got.b, got.c) == (want.curve, want.a, want.b, want.c)
    pvk = prepare_verifying_key(pk.vk)
    assert verify_proof(pvk, got, [x_sum])
    assert not verify_proof(pvk, got, [(x_sum + 1) % c.r])
    assert jverify(jprepare(vk), JProof(curve=got.curve, a=got.a, b=got.b, c=got.c), [x_sum])
