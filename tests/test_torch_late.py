"""The slowest cases of three port test files, moved here unchanged so
that pytest-xdist's --dist loadfile (files by case count, largest first)
hands them out after tests/test_gadget.py, whose single worker sets the
suite's wall, instead of ahead of it: prove_batch against the exact
prover (test_torch_batch.py's one CPU-MSM test), the bls12_381 device
setup (test_torch_setup.py) and the one-point 254-bit G1 MSM lanes
(test_torch_msm.py).  Each keeps its name, its parameters and its
checks (see the docstrings of those files); three cases."""

import pytest
import torch
from test_torch_batch import _silly
from test_torch_msm import test_msm_g1_lanes as _msm_g1_lanes
from test_torch_setup import test_setup_device_matches_jax_and_exact as _setup_device_matches_jax_and_exact

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import prepare_verifying_key as jprepare
from groth16_tpu.protocol import verify_proof as jverify
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.prover_torch import TorchProver
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

torch.set_num_threads(1)


def test_prove_batch_matches_exact_prover():
    """Two proofs of different assignments in one batch (one fetch for
    both): each equals the exact prover's for its r and s and verifies
    under both packages' verifiers, and fails with a wrong input."""
    curve = "bn254"
    c = get_curve(curve)
    jpk, jvk, cs, _, _ = _silly(curve)
    rng = JRng(0xBA7)
    cases = [(3, 5), (7, 11)]
    zs = []
    for a, b in cases:
        cs_i = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
        MySillyCircuit(a=a, b=b)(cs_i)
        zs.append(cs_i.full_assignment())
    rs = [rng.field_element(c.r) for _ in cases]
    ss = [rng.field_element(c.r) for _ in cases]
    prover = TorchProver(proving_key_from_reference(jpk), cs.to_matrices(), device="cpu")
    proofs = prover.prove_batch(zs, rs, ss)
    pvk, jpvk = prepare_verifying_key(prover.pk.vk), jprepare(jvk)
    for proof, (a, b), r, s in zip(proofs, cases, rs, ss):
        want = create_proof_with_reduction(JSilly(a=a, b=b), jpk, r, s)
        assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
        assert verify_proof(pvk, proof, [a * b % c.r])
        assert not verify_proof(pvk, proof, [(a * b + 1) % c.r])
        assert jverify(jpvk, JProof(curve=curve, a=proof.a, b=proof.b, c=proof.c), [a * b % c.r])
    with pytest.raises(ValueError):
        prover.prove_batch(zs, rs[:1], ss)


@pytest.mark.parametrize("curve", ["bls12_381"])
def test_setup_device_matches_jax_and_exact(curve):
    _setup_device_matches_jax_and_exact(curve)


@pytest.mark.parametrize("n,bits", [(1, 254)])
def test_msm_g1_lanes(n, bits):
    _msm_g1_lanes(n, bits)
