"""Batch / pipeline parallelism over proofs.

Port of `groth16_tpu/par/batch_pp.py` (SURVEY.md §2.4 "batch_pp"):

  1. `prove_batch_sharded` — the batch axis over the ranks of a mesh
     (par/mesh.py): each rank proves its B/S proofs with the whole key
     (a `TorchProver`, grouped layout) and the device assembly, with no
     communication until one all_gather of the six output tensors;
     every rank then decodes all B proofs, in order.  It composes with
     par/prover_dp.py (one big proof sharded over ranks) as the two
     extremes of the mesh layout.
  2. `ProofStream` — pipelining on one card: up to `depth` proofs'
     device work is enqueued before the host waits on the oldest result.
     The CUDA stream is the pipeline: the host encodes proof i + 1 and
     decodes proof i - 1 while the card computes proof i.  Each proof is
     assembled on the card (`TorchProver.prove_encoded`) and fetched in
     one copy (`decode_proof_arrays`).

Resumable long batches (checkpoint every proof) layer on top in
utils/resume.py.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Sequence

import torch

from groth16_tpu_torch.par.collectives import all_gather_leaves
from groth16_tpu_torch.par.mesh import DATA_AXIS
from groth16_tpu_torch.protocol.data_structures import Proof
from groth16_tpu_torch.protocol.prover_torch import TorchProver, decode_proof_arrays
from groth16_tpu_torch.utils import profiling


def prove_batch_sharded(
    prover: TorchProver,
    assignments: Sequence[Sequence[int]],
    rs: Sequence[int],
    ss: Sequence[int],
    mesh,
    axis=DATA_AXIS,
) -> List[Proof]:
    """B proofs, batch axis sharded over `mesh`: rank i proves proofs
    [i B/S, (i + 1) B/S) on its own card with the whole key (`prover`,
    built on the mesh's device), then one all_gather of the six output
    tensors gives every rank all B.  B must be a multiple of the mesh
    axis size; every rank passes the same arguments and gets the same
    proofs."""
    ax = mesh.axis(axis)
    B, S = len(assignments), ax.size
    if B % S:
        raise ValueError(f"prove_batch_sharded: batch {B} not divisible by mesh size {S}")
    if not len(rs) == len(ss) == B:
        raise ValueError(f"prove_batch_sharded: {B} assignments, {len(rs)} r and {len(ss)} s")
    rr = prover.c.r
    k = B // S
    mine = range(ax.index * k, (ax.index + 1) * k)
    outs = [prover.prove_encoded(prover.encode_assignment(assignments[i]), rs[i] % rr, ss[i] % rr) for i in mine]
    local = [torch.stack([o[j] for o in outs]) for j in range(6)]  # each [B/S, ...]
    every = [x.reshape((B,) + tuple(x.shape[2:])).cpu() for x in all_gather_leaves(local, ax, "prove_batch_sharded")]
    return [decode_proof_arrays(prover.curve, tuple(x[i] for x in every)) for i in range(B)]


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
        decode position.  Each job's spans (utils/profiling) carry its own
        id: the encode and dispatch of job i + depth and the fetch of job
        i are told apart."""
        pending: deque = deque()
        for assignment, r, s in jobs:
            rr = self.prover.c.r
            with profiling.job() as i:
                z = self.prover.encode_assignment(assignment)
                pending.append((i, self.prover.prove_encoded(z, r % rr, s % rr)))  # no host sync yet
            if len(pending) > self.depth:
                yield self._decode(*pending.popleft())
        while pending:
            yield self._decode(*pending.popleft())

    def _decode(self, i, out) -> Proof:
        with profiling.job(i):
            return decode_proof_arrays(self.prover.curve, out)
