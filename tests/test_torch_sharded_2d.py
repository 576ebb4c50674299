"""The port's multi-device prover on a 2 x 2 ("host", "chip") mesh of
gloo ranks on the CPU (par/mesh.make_mesh_2d): the axes' sizes, lines
and groups, and a proof with axis=("host", "chip") equal to the 1-D
mesh's and to the JAX package's exact prover's; and the launcher's
refusal of NCCL without a card.  Tolerance: equality.
"""

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.par.dryrun import rank_calls, rank_mesh_axes, rank_prove
from groth16_tpu_torch.par.mesh import run_ranks
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

CURVE = "bn254"
torch.set_num_threads(1)


def test_axis_size_on_host_chip_mesh():
    outs = run_ranks(rank_mesh_axes, 4, "gloo", "cpu", (2, 2))
    for rank, o in enumerate(outs):
        host, chip = divmod(rank, 2)
        assert o["sizes"] == {"host": 2, "chip": 2, ("host", "chip"): 4}
        assert o["lines"] == {
            "host": ([chip, 2 + chip], host),
            "chip": ([2 * host, 2 * host + 1], chip),
            ("host", "chip"): ([0, 1, 2, 3], rank),
        }


def test_prove_on_host_chip_mesh_matches_1d_and_exact():
    c = get_curve(CURVE)
    nc, nv = 30, 15  # 2 S^2 - 2 constraints at S = 4
    jpk, jvk = jsetup(JDummy(nv, nc), CURVE, JRng(0x2D))
    r, s = 0x3E51, 0x0B7D
    expect = create_proof_with_reduction(JDummy(nv, nc, a=3, b=5), jpk, r, s)
    pk = proving_key_from_reference(jpk)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nv, nc, a=3, b=5)(cs)
    pvk = prepare_verifying_key(pk.vk)
    args = (pk, cs.to_matrices(), cs.full_assignment(), r, s)
    calls = [(rank_prove, args + ((2, 2), ("host", "chip"))), (rank_prove, args)]
    outs = run_ranks(rank_calls, 4, "gloo", "cpu", calls)
    for two_d, one_d in outs:
        assert two_d["size"] == one_d["size"] == 4
        assert two_d["index"] == one_d["index"]  # host-major: the flattened index is the rank
        for got in (two_d["proof"], one_d["proof"]):
            assert (got.a, got.b, got.c) == (expect.a, expect.b, expect.c)
    assert verify_proof(pvk, outs[0][0]["proof"], [15])


def test_run_ranks_refuses_nccl_without_a_card():
    """No fallback: NCCL takes a card a rank; asked for on the CPU (or on
    a machine without a card) the launcher raises before starting a rank."""
    with pytest.raises((ValueError, RuntimeError)):
        run_ranks(rank_mesh_axes, 2, "nccl", "cpu", (1, 2))
    with pytest.raises(ValueError, match="backend"):
        run_ranks(rank_mesh_axes, 2, "mpi", "cpu", (1, 2))
