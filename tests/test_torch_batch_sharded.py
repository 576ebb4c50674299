"""The port's batch parallelism over ranks (par/batch_pp.prove_batch_sharded)
and its named collectives (par/collectives.py) over gloo ranks on the
CPU: a batch of 4 at S = 2 equal proof by proof to the JAX package's
exact prover, and transpose_a2a, gather_tree_reduce, psum_field and
ring_shift at S = 4 (and at S = 1, where they are local) against their
definitions.  Tolerance: equality
(mod p for psum_field).
"""

import numpy as np
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.par.dryrun import rank_batch, rank_collectives
from groth16_tpu_torch.par.mesh import run_ranks
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

CURVE = "bn254"
torch.set_num_threads(1)


def test_prove_batch_sharded_s2_b4_matches_exact():
    c = get_curve(CURVE)
    nc, nv = 6, 3
    jpk, _ = jsetup(JDummy(nv, nc), CURVE, JRng(0xBA7C))
    pk = proving_key_from_reference(jpk)
    pvk = prepare_verifying_key(pk.vk)
    abs_ = [(3, 5), (2, 7), (11, 13), (6, 6)]
    rs = [0x1234, 0x2345, 0x3456, 0x4567]
    ss = [0x5678, 0x6789, 0x789A, 0x89AB]
    zs, mats = [], None
    for a, b in abs_:
        cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
        DummyCircuit(nv, nc, a=a, b=b)(cs)
        zs.append(cs.full_assignment())
        mats = cs.to_matrices()
    outs = run_ranks(rank_batch, 2, "gloo", "cpu", pk, mats, zs, rs, ss)
    assert outs[0] == outs[1]
    for (a, b), r, s, got in zip(abs_, rs, ss, outs[0]):
        expect = create_proof_with_reduction(JDummy(nv, nc, a=a, b=b), jpk, r, s)
        assert (got.a, got.b, got.c) == (expect.a, expect.b, expect.c)
        assert verify_proof(pvk, got, [a * b % c.r])


def test_collectives_s4_match_definitions():
    S = 4
    p = get_curve(CURVE).r
    outs = run_ranks(rank_collectives, S, "gloo", "cpu", 0xC011)
    X, V, F = outs[0]["X"], outs[0]["V"], outs[0]["F"]
    for i, o in enumerate(outs):
        # global [L, R, C] -> [L, C, R], this rank's C/S columns
        assert np.array_equal(o["transpose"], np.swapaxes(X, 1, 2)[:, 4 * i : 4 * i + 4])
        assert np.array_equal(o["tree_sum"], V.sum(axis=0))
        assert o["psum"] == [sum(col) % p for col in zip(*F)]
        assert np.array_equal(o["ring"], V[(i - 1) % S, :4])  # rank i - 1's block
        assert o["traffic"]["transpose_a2a"] == {"calls": 1, "bytes": X.size * 4 // S}


def test_collectives_s1_are_local():
    """At S = 1 each collective is its definition on the one rank's part,
    and transpose_a2a is a local transpose that hands nothing to the
    backend."""
    p = get_curve(CURVE).r
    (o,) = run_ranks(rank_collectives, 1, "gloo", "cpu", 0xC012)
    assert np.array_equal(o["transpose"], np.swapaxes(o["X"], 1, 2))
    assert o["transpose_contiguous"]
    assert "transpose_a2a" not in o["traffic"]
    assert np.array_equal(o["tree_sum"], o["V"][0])
    assert o["psum"] == [v % p for v in o["F"][0]]
    assert np.array_equal(o["ring"], o["V"][0, :4])
