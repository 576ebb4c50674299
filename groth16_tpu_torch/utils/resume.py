"""Batch-prover checkpoint/resume (SURVEY.md §5.3/§5.4 build analogs).

The reference has no runtime persistence (keys are serialized once,
data_structures.rs:8); at production batch sizes the useful recovery
unit is the PROOF: `prove_batch_resumable` persists each completed proof
to disk and skips already-completed work on restart, so a crashed or
preempted batch run restarts from the last completed proof instead of
the beginning.  Integrity: every stored proof is re-verified against its
public inputs on load (a flipped bit fails pairing verification with
overwhelming probability, so verification doubles as the checksum).

Copy of `groth16_tpu/utils/resume.py` for the port's TorchProver."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from groth16_tpu_torch.protocol.data_structures import Proof
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.serde import deserialize_proof, serialize_proof


def prove_batch_resumable(
    prover,
    vk,
    assignments: Sequence[Sequence[int]],
    public_inputs: Sequence[Sequence[int]],
    rs: Sequence[int],
    ss: Sequence[int],
    checkpoint_dir: str,
    verify_on_load: bool = True,
) -> List[Proof]:
    """Prove a batch with per-proof durability.

    prover: protocol.prover_torch.TorchProver (or any object with
    .prove(assignment, r, s));
    checkpoint_dir: proofs stored as proof_{i:06d}.bin (ark serde bytes).
    Returns all proofs in order.  Restart-safe: completed indices are
    loaded (and by default re-verified) instead of re-proved; a stored
    proof that fails verification is treated as corrupt and re-proved.
    """
    os.makedirs(checkpoint_dir, exist_ok=True)
    curve = vk.curve
    pvk = prepare_verifying_key(vk) if verify_on_load else None
    out: List[Optional[Proof]] = [None] * len(assignments)
    for i, (z, pub, r, s) in enumerate(
        zip(assignments, public_inputs, rs, ss)
    ):
        path = os.path.join(checkpoint_dir, f"proof_{i:06d}.bin")
        if os.path.exists(path):
            try:
                proof = deserialize_proof(
                    open(path, "rb").read(), curve, compress=True
                )
                if pvk is None or verify_proof(pvk, proof, list(pub)):
                    out[i] = proof
                    continue
            except Exception:
                pass  # corrupt checkpoint: fall through and re-prove
        proof = prover.prove(list(z), r, s)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(serialize_proof(proof, compress=True))
        os.replace(tmp, path)  # atomic: no torn checkpoints
        out[i] = proof
    return out
