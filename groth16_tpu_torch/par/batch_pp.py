"""Pipeline parallelism over proofs on one card.

Port of `ProofStream` of `groth16_tpu/par/batch_pp.py` (SURVEY.md §2.4
"batch_pp"): up to `depth` proofs' device work is enqueued before the
host waits on the oldest result.  The CUDA stream is the pipeline: the
host encodes proof i + 1 and decodes proof i - 1 while the card computes
proof i.  Each proof is assembled on the card (`TorchProver.prove_encoded`)
and fetched in one copy (`decode_proof_arrays`).  `prove_batch_sharded`,
the batch axis over several cards, waits for the multi-device slice.

Resumable long batches (checkpoint every proof) layer on top in
utils/resume.py.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Sequence

from groth16_tpu_torch.protocol.data_structures import Proof
from groth16_tpu_torch.protocol.prover_torch import TorchProver, decode_proof_arrays


class ProofStream:
    """Software-pipelined proof stream on one card: keeps up to `depth`
    proofs in flight on the device queue (the PP analog of overlapping
    the witness/NTT/MSM stages of DIFFERENT proofs, SURVEY.md §2.4)."""

    def __init__(self, prover: TorchProver, depth: int = 2):
        if depth < 1:
            raise ValueError(f"ProofStream: depth must be at least 1, got {depth}")
        self.prover = prover
        self.depth = depth

    def prove_all(self, jobs: Iterable[tuple[Sequence[int], int, int]]) -> Iterator[Proof]:
        """jobs: iterable of (full_assignment, r, s).  Yields proofs in
        order, with at most `depth` proofs enqueued ahead of the host
        decode position."""
        pending: deque = deque()
        for assignment, r, s in jobs:
            rr = self.prover.c.r
            z = self.prover.encode_assignment(assignment)
            pending.append(self.prover.prove_encoded(z, r % rr, s % rr))  # no host sync yet
            if len(pending) > self.depth:
                yield decode_proof_arrays(self.prover.curve, pending.popleft())
        while pending:
            yield decode_proof_arrays(self.prover.curve, pending.popleft())
