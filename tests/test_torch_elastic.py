"""The port's elastic prover (par/elastic.py) over gloo ranks on the
CPU: proof self-verification as the detector, per-shard MSM checksums
as the localizer, and mesh-shrinking retry as the recovery, with faults
injected by `fault_hook` (par/dryrun.InjectedFault) on every rank.  The
proofs are held against the JAX package's exact prover.  Tolerance:
equality.
"""

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.par.dryrun import InjectedFault, rank_elastic
from groth16_tpu_torch.par.elastic import SELF_CHECK_FAILED
from groth16_tpu_torch.par.mesh import run_ranks
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

CURVE = "bn254"
torch.set_num_threads(1)


def _fixture(S, seed):
    """(args of rank_elastic before its scenarios, the exact proof) for a
    DummyCircuit of 2 S^2 - 2 constraints."""
    c = get_curve(CURVE)
    nc = 2 * S * S - 2
    nv = max(3, nc // 2)
    jpk, _ = jsetup(JDummy(nv, nc), CURVE, JRng(seed))
    r, s = 0x1F2E, 0x3D4C
    expect = create_proof_with_reduction(JDummy(nv, nc, a=3, b=5), jpk, r, s)
    pk = proving_key_from_reference(jpk)
    prepare_verifying_key(pk.vk)  # builds the native verifier before the ranks need it
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nv, nc, a=3, b=5)(cs)
    return (pk, cs.to_matrices(), cs.full_assignment(), r, s), expect


def _same(proof, expect):
    return (proof.a, proof.b, proof.c) == (expect.a, expect.b, expect.c)


def test_healthy_prove_checked_single_attempt_and_no_faults():
    args, expect = _fixture(2, 0xFA11)
    outs = run_ranks(rank_elastic, 2, "gloo", "cpu", *args, [(None, 3, True)])
    for (o,) in outs:
        assert _same(o["proof"], expect)
        assert not o["report"].retried and o["report"].attempts[0].ok
        assert o["n_devices"] == 2
        assert o["faults"] == []


def test_sdc_retried_and_persistent_fault_raises():
    args, expect = _fixture(2, 0xFA12)
    scenarios = [(InjectedFault("sdc", (0,)), 3, False), (InjectedFault("sdc", None), 2, False)]
    outs = run_ranks(rank_elastic, 2, "gloo", "cpu", *args, scenarios)
    for sdc, persistent in outs:
        assert _same(sdc["proof"], expect)
        assert sdc["report"].retried and sdc["n_devices"] == 2
        assert sdc["report"].attempts[0].error == SELF_CHECK_FAILED
        assert persistent["proof"] is None
        assert persistent["error"].startswith("no valid proof after 2 attempts")
    assert outs[0][1]["error"] == outs[1][1]["error"]


@pytest.mark.parametrize("S", [4])
def test_device_loss_shrinks_mesh_same_proof(S):
    args, expect = _fixture(S, 0xFA13)
    outs = run_ranks(rank_elastic, S, "gloo", "cpu", *args, [(InjectedFault("loss", (0,)), 3, False)])
    for (o,) in outs:  # every rank, also those left out of the shrunk mesh, returns the same
        assert _same(o["proof"], expect)
        assert o["report"].retried and not o["report"].attempts[0].ok
        assert "device lost" in o["report"].attempts[0].error
        assert [a.n_devices for a in o["report"].attempts] == [S, S // 2]
        assert o["n_devices"] == S // 2
