"""The port's copy of the recursive verifier gadgets
(groth16_tpu_torch.gadgets) against the JAX package's (groth16_tpu.gadgets).

- The copy is the JAX package's code: every module statement for
  statement, docstrings aside, but for the package of its imports.
- Both build the same constraint system: the absorb gadgets on a
  BLS12-377 MySillyCircuit proof and its verifying key, and to_bits_le /
  to_bytes_le on field variables, give the same matrices and the same
  assignment in both packages, and it is satisfied.
- G1Var's general-a complete law (the MNT families') equals the affine
  group law on every pair of points of the odd-order subgroup of one toy
  curve of tests/test_gadget_mnt.py.

tests/test_gadget.py (the verifier gadget itself, ~20 min on one worker)
is not mirrored.  Tolerance: exact (constraint systems and field values
are integers)."""

import ast
import itertools
import os

import pytest

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.protocol.data_structures import Proof
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INNER = "bls12_377"  # the outer constraint field is its base field (BW6-761's r)


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


def test_the_copy_is_the_jax_packages_gadgets():
    ours, theirs = (os.path.join(ROOT, pkg, "gadgets") for pkg in ("groth16_tpu_torch", "groth16_tpu"))
    names = sorted(f for f in os.listdir(theirs) if f.endswith(".py"))
    assert names == sorted(f for f in os.listdir(ours) if f.endswith(".py"))
    assert len(names) == 6
    for name in names:
        assert _code(os.path.join(ours, name)) == _code(os.path.join(theirs, name)), name


def _absorb_and_bits(pkg, vk, proof, p):
    """One constraint system over p built with package `pkg`'s gadgets:
    the verifying key's and the proof's absorb streams, and the canonical
    bits and bytes of a few field variables.  -> (matrices as plain
    lists, full assignment, satisfied, the streams' values)."""
    import importlib

    absorb = importlib.import_module(f"{pkg}.gadgets.absorb_var")
    g16 = importlib.import_module(f"{pkg}.gadgets.groth16_var")
    std = importlib.import_module(f"{pkg}.gadgets.r1cs_std")
    system = importlib.import_module(f"{pkg}.r1cs.system")

    cs = system.ConstraintSystem(p, mode=system.SynthesisMode.PROVE)
    vk_var = g16.VerifyingKeyVar(cs, INNER, vk=vk)
    streams = [
        [e.value for e in absorb.vk_to_sponge_field_elements_var(vk_var)],
        [b.value for b in absorb.vk_to_sponge_bytes_var(vk_var)],
        [e.value for e in absorb.proof_to_field_elements_var(g16.ProofVar(cs, proof))],
    ]
    for v in (0, 1, p - 1, 0x1234567890ABCDEF, p // 3):
        x = std.FpVar.new_witness(cs, v)
        streams.append([int(b.var.value) for b in std.to_bits_le(x)])
        streams.append([b.value for b in std.to_bytes_le(x)])
    m = cs.to_matrices()
    mats = (m.num_instance_variables, m.num_witness_variables, m.num_constraints, m.a, m.b, m.c)
    return mats, cs.full_assignment(), cs.is_satisfied(), streams


def test_gadget_constraint_systems_match_jax():
    c = get_curve(INNER)
    rng = JRng(9)
    jpk, jvk = jsetup(JSilly(), INNER, rng)
    jproof = create_proof_with_reduction(JSilly(a=4, b=7), jpk, rng.field_element(c.r), rng.field_element(c.r))
    vk = proving_key_from_reference(jpk).vk
    proof = Proof(curve=jproof.curve, a=jproof.a, b=jproof.b, c=jproof.c)
    got = _absorb_and_bits("groth16_tpu_torch", vk, proof, c.p)
    want = _absorb_and_bits("groth16_tpu", jvk, jproof, c.p)
    assert got[0] == want[0], "matrices differ"
    assert got[1] == want[1], "assignments differ"
    assert got[2] and want[2], "unsatisfied"
    assert got[3] == want[3]
    nbytes = (c.p.bit_length() + 7) // 8
    assert bytes(got[3][-1]) == (c.p // 3).to_bytes(nbytes, "little")


@pytest.mark.parametrize("p,a,b", [(107, 2, 4)])
def test_general_a_complete_law(p, a, b):
    """G1Var.add for a != 0 (the bidegree-(2,2) law) on every pair of the
    odd-order subgroup of y^2 = x^3 + a x + b over F_p (infinity,
    doublings and inverses included) equals the affine group law."""
    from groth16_tpu_torch.gadgets.curve_var import G1Var
    from groth16_tpu_torch.gadgets.r1cs_std import FpVar
    from groth16_tpu_torch.r1cs.system import ConstraintSystem

    def ref_add(A, B):
        if A is None:
            return B
        if B is None:
            return A
        (x1, y1), (x2, y2) = A, B
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = (3 * x1 * x1 + a) * pow(2 * y1, p - 2, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    def mul(P, k):
        R = None
        while k:
            if k & 1:
                R = ref_add(R, P)
            P, k = ref_add(P, P), k >> 1
        return R

    assert (4 * a**3 + 27 * b * b) % p != 0
    pts = [None] + [(x, y) for x in range(p) for y in range(p) if (y * y - (x * x * x + a * x + b)) % p == 0]
    n, two = len(pts), 1
    while n % 2 == 0:
        n //= 2
        two *= 2
    sub = list({mul(P, two) for P in pts})
    assert len(sub) == n > 2
    cs = ConstraintSystem(p)

    def g1v(P):
        if P is None:
            return G1Var.identity(cs, 3 * b % p, a)
        return G1Var.from_affine_var(cs, FpVar.constant(cs, P[0]), FpVar.constant(cs, P[1]), 3 * b % p, a)

    for A, B in itertools.product(sub, sub):
        assert g1v(A).add(g1v(B)).value() == ref_add(A, B), (A, B)
