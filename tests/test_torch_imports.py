"""The port stands alone: no module of groth16_tpu_torch, and neither
chip_smoke.py nor chip_ab.py, imports jax or the JAX package
groth16_tpu."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "groth16_tpu")


def _sources():
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "chip_ab.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "groth16_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_package():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"chip_smoke.py", "chip_ab.py"} <= names
    for module in (
        ("protocol", "prover_torch.py"),
        ("protocol", "generator_torch.py"),
        ("msm", "fixed_base.py"),
        ("utils", "ubench.py"),
        ("utils", "resume.py"),
        ("par", "batch_pp.py"),
        ("serde", "canonical.py"),
        ("protocol", "absorb.py"),
        ("native", "__init__.py"),
        ("bench.py",),
        ("gadgets", "__init__.py"),
        ("gadgets", "absorb_var.py"),
        ("gadgets", "curve_var.py"),
        ("gadgets", "groth16_var.py"),
        ("gadgets", "pairing_var.py"),
        ("gadgets", "r1cs_std.py"),
        ("r1cs", "gadget_circuit.py"),
    ):
        assert os.path.join("groth16_tpu_torch", *module) in names
