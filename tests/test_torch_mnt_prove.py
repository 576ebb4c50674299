"""MNT4-298 and MNT6-298 proves through TorchProver on the CPU (every
kernel's plain version) against the JAX package's exact prover: the
JAX package's device key (MNT6: G2 points over Fq3 in the grouped layout)
carried across by device_key_from_numpy equals the port's own upload;
the same key, assignment, r and s give the same proof, coordinate for
coordinate, from one run of the witness map and the MSMs, assembled on
the host (`prove`'s assembly) and on the device (`prove(host_assembly=
False)`'s, with r and s of 12-16 bits: the plain scalar multiplication's
select loop costs an addition a bit); the proofs verify under both
packages' verifiers and fail with a wrong public input.  Two cases, so pytest-xdist's --dist
loadfile hands the file out after tests/test_gadget.py."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_prover import _assert_same, _synth, jax_tree_to_numpy

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import prepare_verifying_key as jprepare
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol import verify_proof as jverify
from groth16_tpu.protocol.data_structures import Proof as JProof
from groth16_tpu.protocol.device_keys import upload_proving_key as jupload
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.protocol.device_keys import (
    LEAF_FIELDS,
    STATIC_FIELDS,
    device_key_from_numpy,
    proving_key_from_reference,
    upload_proving_key,
)
from groth16_tpu_torch.protocol.prover_torch import (
    TorchProver,
    assembly_phase,
    decode_proof_arrays,
    msm_g1_phase,
    msm_g2_phase,
    scalar_bits,
    witness_phase,
)
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.circuits import MySillyCircuit

torch.set_num_threads(1)


@pytest.mark.parametrize("curve", ["mnt4_298", "mnt6_298"])
def test_mnt_prove_matches_exact_prover(curve):
    c = get_curve(curve)
    rng = JRng(0x298)
    jpk, jvk = jsetup(JSilly(), curve, rng)
    a, b = rng.field_element(c.r), rng.field_element(c.r)
    pk = proving_key_from_reference(jpk)
    cs = _synth(MySillyCircuit(a=a, b=b), c.r)
    m = cs.to_matrices()

    jdpk = jupload(jpk, m)
    leaves = {f: getattr(jdpk, f) for f in LEAF_FIELDS}
    leaves["mats"] = {
        k: {f: (np.asarray(x) if f != "num_rows" else x) for f, x in dataclasses.asdict(v).items()}
        for k, v in jdpk.mats.items()
    }
    leaves = {f: (v if f == "mats" else jax_tree_to_numpy(v)) for f, v in leaves.items()}
    carried = device_key_from_numpy(leaves, {f: getattr(jdpk, f) for f in STATIC_FIELDS}, device="cpu")
    own = upload_proving_key(pk, m, device="cpu")
    assert own.b_g2_tail[0].shape[:2] == (21, c.g2_field_degree)
    for f in LEAF_FIELDS + STATIC_FIELDS:
        _assert_same(getattr(carried, f), getattr(own, f), f)

    prover = TorchProver(pk, m, device="cpu")
    pvk, jpvk = prepare_verifying_key(pk.vk), jprepare(jvk)
    public = a * b % c.r
    scalars_g, rho = witness_phase(prover.dpk, prover.encode_assignment(cs.full_assignment()))
    acc4, b2 = msm_g1_phase(prover.dpk, scalars_g), msm_g2_phase(prover.dpk, rho)
    # the host assembly at full-width r and s, the device one at short ones
    for r, s, host in ((rng.field_element(c.r), rng.field_element(c.r), True), (0xB3A5, 0x7E1, False)):
        want = create_proof_with_reduction(JSilly(a=a, b=b), jpk, r, s)
        if host:
            proof = prover._assemble(acc4, b2, r, s)
        else:
            bits = scalar_bits([r, s, r * s % c.r], "cpu")
            proof = decode_proof_arrays(curve, assembly_phase(prover.dpk, acc4, b2, bits))
        assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c)
        assert verify_proof(pvk, proof, [public])
        assert not verify_proof(pvk, proof, [(public + 1) % c.r])
        assert jverify(jpvk, JProof(curve=curve, a=proof.a, b=proof.b, c=proof.c), [public])
