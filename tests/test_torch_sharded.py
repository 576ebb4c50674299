"""The port's multi-device path on the CPU, over gloo across processes
(par/mesh.run_ranks; one thread a rank), against the JAX package's exact
engine: the four-step ShardedNtt at S = 4 against RefDomain and the
port's NttDomain, msm_sharded_lanes at S = 2 against the exact MSM, and
a ShardedProver proof at S = 2 against create_proof_with_reduction's on
every rank.  Tolerance: equality (mod p for field values, as affine
points for group elements).  Three cases, so that pytest-xdist's
--dist loadfile hands the file out after the long tests/test_gadget.py.
"""

import random

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import prepare_verifying_key as jprepare
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol import verify_proof as jverify
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import DummyCircuit as JDummy
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.domain import RefDomain
from groth16_tpu.ref.group import FpCtx, JacobianOps
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.fields.spec import decode, make_spec
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.par.dryrun import rank_msm, rank_ntt, rank_prove
from groth16_tpu_torch.par.mesh import run_ranks
from groth16_tpu_torch.par.ntt_cp import ShardedNtt
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

CURVE = "bn254"
torch.set_num_threads(1)


def test_sharded_ntt_s4_matches_ref_domain():
    c = get_curve(CURVE)
    n, S = 32, 4
    rng = random.Random(4)
    coeffs = [rng.randrange(c.r) for _ in range(n)]
    outs = run_ranks(rank_ntt, S, "gloo", "cpu", CURVE, coeffs)
    spec = make_spec(c.fr.modulus)
    ref = RefDomain(c.fr, n)
    coset = ref.get_coset(c.fr.generator)
    expect = {
        "fft": ref.fft(coeffs),
        "ifft": ref.ifft(coeffs),
        "coset_fft": coset.fft(coeffs),
        "coset_ifft": coset.ifft(coeffs),
    }
    for name, want in expect.items():
        got = [v for o in outs for v in decode(o["local"][name], spec)]  # rank order = element order
        assert got == want, name
        assert all(o["equal_single"][name] for o in outs), name  # the port's NttDomain, digit for digit
    # radix-2 domains only, as in the JAX package (MNT6-298's Fr: 2-adicity 17)
    mixed = NttDomain(get_curve("mnt6_298").fr, 1 << 18, "cpu")
    assert mixed.radixes
    with pytest.raises(ValueError, match="radix-2"):
        ShardedNtt(mixed, None)


def test_sharded_msm_s2_matches_exact():
    c = get_curve(CURVE)
    ref = RefGroups(CURVE)
    rng = random.Random(9)
    base = ref.g1_sample(3)
    pts = [ref.g1_mul(base, rng.randrange(1, c.r)) for _ in range(16)]
    scalars = [rng.randrange(c.r) for _ in range(16)]
    outs = run_ranks(rank_msm, 2, "gloo", "cpu", CURVE, pts, scalars)
    exact = JacobianOps(FpCtx(c.p))
    expect = exact.to_affine(exact.msm(pts, scalars))
    assert all(o == [expect, expect] for o in outs)


def test_sharded_prover_s2_matches_exact():
    c = get_curve(CURVE)
    nc, nv = 6, 3  # 2 S^2 - 2 constraints at S = 2
    jpk, jvk = jsetup(JDummy(nv, nc), CURVE, JRng(77))
    r, s = 0x9A3B, 0x51C7
    expect = create_proof_with_reduction(JDummy(nv, nc, a=3, b=5), jpk, r, s)
    pk = proving_key_from_reference(jpk)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nv, nc, a=3, b=5)(cs)
    pvk = prepare_verifying_key(pk.vk)  # builds the native verifier before the ranks need it
    outs = run_ranks(rank_prove, 2, "gloo", "cpu", pk, cs.to_matrices(), cs.full_assignment(), r, s)
    for o in outs:
        got = o["proof"]
        assert (got.a, got.b, got.c) == (expect.a, expect.b, expect.c)
        assert o["key_shard"]["g1_points"] == 4 * (pk_n_pad(pk) // 2)  # this rank's half of the stack
        assert o["launches"]["mont_mul"] == 0  # the CPU runs the plain versions
    assert verify_proof(pvk, outs[0]["proof"], [15])
    assert not verify_proof(pvk, outs[0]["proof"], [16])
    assert jverify(jprepare(jvk), JProof(curve=CURVE, a=got.a, b=got.b, c=got.c), [15])


def pk_n_pad(pk) -> int:
    n = max(len(pk.h_query), len(pk.l_query), len(pk.a_query) - 1)
    return -(-n // 2) * 2
