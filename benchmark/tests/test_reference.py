"""The plain reference against proofs the program made (on the CPU, a 2^6
DummyCircuit on bls12_381 and on mnt6_298; make_reference_fixture.py),
without importing the program."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.circuits import bench_dummy
from benchmark.lib import check
from benchmark.reference.groth16 import CurveSpec, Reference, ToxicWaste

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CASES = json.load(open(os.path.join(HERE, "data", "reference_fixture.json")))


def ints(x):
    if x is None:
        return None
    return tuple(ints(v) for v in x) if isinstance(x, list) else int(x)


def reference(case):
    spec = CurveSpec.from_json(case["curve"])
    waste = ToxicWaste(**{k: int(v) for k, v in case["waste"].items()})
    circuit, _ = bench_dummy.reference_circuit(case)
    return spec, waste, circuit, Reference(spec, waste, circuit)


@pytest.mark.parametrize("case", CASES, ids=[c["curve"]["name"] for c in CASES])
def test_accepts_the_programs_proof_and_key(case):
    spec, waste, circuit, ref = reference(case)
    z, r, s = ints(case["z"]), int(case["r"]), int(case["s"])
    ev = ref.evaluate(z)
    assert ev["unsatisfied_rows"] == 0
    assert ref.proof(ev, z, r, s) == ints(case["proof"])
    assert [check.norm(p) for p in check.vk_points(ref.verifying_key(ev))] == [ints(p) for p in case["vk"]]
    vk = dict(zip(["alpha_g1", "beta_g2", "gamma_g2", "delta_g2"], [ints(p) for p in case["vk"][:4]]),
              gamma_abc_g1=[ints(p) for p in case["vk"][4:]])
    checks = check.compare(case, spec, waste, circuit, None, [z], [(0, r, s, ())], [ints(case["proof"])], vk)
    assert check.is_correct(checks)


@pytest.mark.parametrize("case", CASES, ids=[c["curve"]["name"] for c in CASES])
@pytest.mark.parametrize("where", ["a.x", "b.y", "c.y"])
def test_rejects_a_flipped_coordinate(case, where):
    spec, waste, circuit, ref = reference(case)
    z, r, s = ints(case["z"]), int(case["r"]), int(case["s"])
    proof = [list(p) for p in ints(case["proof"])]
    point, coord = "abc".index(where[0]), "xy".index(where[2])
    v = proof[point][coord]
    proof[point][coord] = (v + 1) % spec.p if isinstance(v, int) else ((v[0] + 1) % spec.p,) + v[1:]
    bad = tuple(tuple(p) for p in proof)
    assert ref.proof(ref.evaluate(z), z, r, s) != bad
    checks = check.compare(case, spec, waste, circuit, None, [z], [(0, r, s, ())], [bad],
                           ref.verifying_key(ref.evaluate(z)))
    assert checks["proofs_differing"]["value"] == 1 and not check.is_correct(checks)


def test_rejects_an_unsatisfying_assignment():
    case = CASES[0]
    _, _, _, ref = reference(case)
    z = list(ints(case["z"]))
    z[1] += 1  # c != a b
    assert ref.evaluate(z)["unsatisfied_rows"] == 59


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.groth16, benchmark.lib.check, "
            "benchmark.circuits.bench_dummy; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'groth16_tpu_torch', 'groth16_tpu', 'jax'}))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
