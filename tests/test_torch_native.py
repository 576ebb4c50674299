"""The port's native C++ verifier engine (groth16_tpu_torch.native) against
the JAX package's (groth16_tpu.native), and the port's verifier and serde
through it.

On bn254, bls12_377, bls12_381 (the Fp12 tower engine) and mnt4_298 (the
Tate engine) the two engines give the same multi-pairing, G1 MSM and
subgroup verdicts on points of the exact engine `groth16_tpu.ref`; on
bn254 the port's engine equals the port's pure-Python pairing; a proof
verifies through the port's verifier and fails with a wrong input; serde
with validate=True rejects a bls12_381 G1 point outside the subgroup.  The
copy is the JAX package's code: pairing.cpp line for line but for the
source paths of its header comment, __init__.py statement for statement
but for the package of its imports.

Tolerance: exact (pairing values, points and verdicts are canonical
integers)."""

import ast
import io
import os

import pytest

from groth16_tpu.curves.params import get_curve
from groth16_tpu.native import native_pairing as jnative_pairing
from groth16_tpu.ref import curve as rc
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.field import sqrt_fp
from groth16_tpu.ref.group import g1_jacobian
from groth16_tpu_torch.native import native_pairing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ["bn254", "bls12_377", "bls12_381", "mnt4_298"]


def _engines(name):
    nat, jnat = native_pairing(name), jnative_pairing(name)
    if nat is None or jnat is None:
        pytest.skip("native engine unavailable (no g++ or disabled)")
    return nat, jnat


def _bad_g1(c):
    """An on-curve G1 point outside the r-order subgroup (cofactor > 1)."""
    x = 2
    while True:
        x += 1
        y = sqrt_fp((x * x * x + c.b) % c.p, c.p)
        if y is not None and rc.mul_fp(c.p, (x, y), c.r) is not None:
            return (x, y)


@pytest.mark.parametrize("name", CURVES)
def test_native_engines_agree(name):
    nat, jnat = _engines(name)
    c = get_curve(name)
    ref = RefGroups(name)
    Ps = [ref.g1_sample(i + 5) for i in range(3)]
    Q = ref.g2_sample(11)
    Qs = [Q, ref.g2_neg(Q), None]
    assert nat.multi_pairing(Ps, Qs) == jnat.multi_pairing(Ps, Qs)
    assert nat.multi_pairing([Ps[0], None], [Qs[0], Qs[1]]) == jnat.pairing(Ps[0], Qs[0])
    scalars = [0, 1, c.r - 1]
    assert nat.g1_msm(Ps, scalars) == jnat.g1_msm(Ps, scalars)
    g1 = g1_jacobian(c)
    assert nat.g1_msm(Ps, scalars) == g1.to_affine(g1.add(g1.from_affine(Ps[1]), g1.neg(g1.from_affine(Ps[2]))))
    assert nat.g1_subgroup_check(Ps + [None]) == jnat.g1_subgroup_check(Ps) == 0
    assert nat.g2_subgroup_check(Qs) == jnat.g2_subgroup_check(Qs[:2]) == 0


def test_native_matches_the_ports_python_pairing():
    from groth16_tpu_torch.ref.pairing import make_pairing

    nat, _ = _engines("bn254")
    ref = RefGroups("bn254")
    Ps = [ref.g1_sample(i + 3) for i in range(2)]
    Qs = [ref.g2_sample(i + 7) for i in range(2)]
    py = make_pairing("bn254")
    assert nat.multi_pairing(Ps, Qs) == py.final_exponentiation(py.multi_miller_loop(Ps, Qs))


def test_native_flags_a_point_outside_the_subgroup():
    nat, jnat = _engines("bls12_381")
    c = get_curve("bls12_381")
    good, bad = RefGroups("bls12_381").g1_sample(2), _bad_g1(c)
    assert nat.g1_subgroup_check([good, bad]) == jnat.g1_subgroup_check([good, bad]) == 1


def test_verify_roundtrip_through_the_native_engine():
    """bls12_377: the port's exact setup and prover, its verifier on the
    native engine (prepare_inputs' native MSM equal to the Python sum);
    the JAX package's verifier accepts the same proof."""
    from groth16_tpu.protocol import prepare_verifying_key as jprepare
    from groth16_tpu.protocol import verify_proof as jverify
    from groth16_tpu.protocol.data_structures import Proof as JProof
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.verifier import prepare_inputs, prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
    from groth16_tpu_torch.utils.rng import Rng

    name = "bls12_377"
    _engines(name)
    c = get_curve(name)
    rng = Rng(77)
    pk, vk = setup(MySillyCircuit(), name, rng)
    a, b = 6, 9
    proof = create_proof_with_reduction(MySillyCircuit(a=a, b=b), pk, rng.field_element(c.r), rng.field_element(c.r))
    pvk = prepare_verifying_key(vk)
    assert verify_proof(pvk, proof, [a * b % c.r])
    assert not verify_proof(pvk, proof, [a])
    g1 = g1_jacobian(c)
    want = g1.add(g1.from_affine(vk.gamma_abc_g1[0]), g1.scalar_mul(g1.from_affine(vk.gamma_abc_g1[1]), a * b % c.r))
    assert prepare_inputs(pvk, [a * b % c.r]) == g1.to_affine(want)
    assert pvk.alpha_g1_beta_g2 == jprepare(vk).alpha_g1_beta_g2
    assert jverify(jprepare(vk), JProof(curve=name, a=proof.a, b=proof.b, c=proof.c), [a * b % c.r])


def test_serde_validate_rejects_a_point_outside_the_subgroup():
    from groth16_tpu_torch.serde.canonical import SerializationError, de_g1, ser_g1

    _engines("bls12_381")
    c = get_curve("bls12_381")
    good, bad = RefGroups("bls12_381").g1_sample(2), _bad_g1(c)
    for compress in (True, False):
        assert de_g1(io.BytesIO(ser_g1(good, c, compress)), c, compress, validate=True) == good
        with pytest.raises(SerializationError, match="subgroup"):
            de_g1(io.BytesIO(ser_g1(bad, c, compress)), c, compress, validate=True)


def _code(path):
    """The module's AST without docstrings, import packages renamed to
    groth16_tpu."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("groth16_tpu_torch", "groth16_tpu")
    return ast.dump(tree)


def test_the_copy_is_the_jax_packages_engine():
    ours, theirs = (os.path.join(ROOT, pkg, "native") for pkg in ("groth16_tpu_torch", "groth16_tpu"))
    assert _code(os.path.join(ours, "__init__.py")) == _code(os.path.join(theirs, "__init__.py"))
    a = open(os.path.join(ours, "src", "pairing.cpp"), "rb").read().splitlines()
    b = open(os.path.join(theirs, "src", "pairing.cpp"), "rb").read().splitlines()
    assert len(a) == len(b)
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(differ) <= 3
    for x, y in differ:
        assert x.startswith(b"//") and y.startswith(b"//") and b"arkworks-rs/groth16 src/verifier.rs" in x
