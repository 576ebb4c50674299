"""The 2^6 DummyCircuit prove of each a = 0 curve through TorchProver on
the CPU (every kernel's plain version) against the JAX package's exact
prover: the same key, assignment, r and s give the same proof, which
verifies under both packages' verifiers and fails with a wrong public
input.  The helpers are test_torch_prover.py's; this file holds three
cases, so pytest-xdist's --dist loadfile (files by case count, largest
first) hands it out after tests/test_gadget.py, whose single worker sets
the suite's wall."""

import pytest
from test_torch_prover import NCON, NVAR, _check, _dummy_setup

from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu_torch.r1cs.circuits import DummyCircuit


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_prover_dummy_2p6(curve):
    jpk, jvk, r, s = _dummy_setup(curve)
    _check(curve, jpk, jvk, JDummy(NVAR, NCON, a=3, b=5), DummyCircuit(NVAR, NCON, a=3, b=5), 15, r, s)
