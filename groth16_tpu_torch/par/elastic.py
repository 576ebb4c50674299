"""Failure detection + elastic recovery for the sharded prover.

Port of `groth16_tpu/par/elastic.py` onto `torch.distributed`.  The
reference is a single-process library whose only failure surface is the
`SynthesisError` result type (arkworks-rs/groth16 src/lib.rs:49,64); at
multi-device scale the failure modes that matter are device loss
mid-run and silent data corruption (SDC) inside long MSM/NTT work.
SURVEY.md §5.3 names the build analog: per-shard checksums of MSM
partials with recompute-on-mismatch, plus restart of batch work from the
last completed proof (utils/resume.py).

Detection is layered:

1. **Protocol self-check** (strongest, O(1) pairings): Groth16's verify
   equation e(A,B) = e(alpha,beta) e(ic,gamma) e(C,delta) covers every
   upstream bit — witness map, 7 NTTs, 5 MSMs, assembly.  A proof that
   verifies is correct regardless of what the hardware did; one that
   does not is discarded and retried.  ElasticProver checks every proof
   (protocol/verifier.py).
2. **Per-shard MSM checksums** (localization): `shard_checksums` re-runs
   the 4-lane G1 MSM keeping each rank's partial accumulator local and
   folds it to one wrapping 32-bit word per shard.  The kernels are
   deterministic, so a run-to-run checksum mismatch pins the flaky rank;
   `localize_faults` reports the shard indices.
3. **Elastic retry**: on an error ElasticProver rebuilds the prover on
   the first half of its ranks — halving the shard count keeps every
   divisibility invariant — re-places the key's shards, and re-proves.
   Proofs are attempt-invariant: the group math is exact, so any mesh
   shape produces the identical proof.

SPMD: every rank of the default group constructs the ElasticProver and
calls `prove_checked` with the same arguments.  Each attempt ends with
an all_reduce of every rank's outcome, so every rank decides alike;
ranks outside the current (shrunk) mesh take no part in its collectives
and wait there; the result of the first rank is broadcast at the end, so
every rank returns the same proof and report (or raises the same error).

The fault model is the JAX package's: an exception raised by the prove or
by the hook (after the prove's collectives, on every rank), or a proof
that fails to verify.  A rank process that dies, or that raises inside a
collective while the others wait, is not survived: that needs collective
timeouts, which the JAX package does not have either.

Fault injection for tests: `ElasticProver.fault_hook` is called as
``fault_hook(attempt, proof)`` after each prove and may return a
corrupted proof (SDC model) or raise (device-loss model).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.msm.pippenger import msm_device_lanes
from groth16_tpu_torch.par.collectives import all_gather_leaves, all_reduce_max
from groth16_tpu_torch.par.mesh import DATA_AXIS, Mesh
from groth16_tpu_torch.par.prover_dp import ShardedProver, _g1_scalar_stack
from groth16_tpu_torch.protocol.data_structures import Proof, ProvingKey
from groth16_tpu_torch.r1cs.matrices import ConstraintMatrices

SELF_CHECK_FAILED = "proof failed self-verification"
# an attempt's outcome, the worst over the ranks decides
OK, BAD_PROOF, RAISED = 0, 1, 2


class ProverFaultError(RuntimeError):
    """Raised when every elastic attempt produced an invalid proof."""


@dataclasses.dataclass
class AttemptReport:
    attempt: int
    n_devices: int
    ok: bool
    error: Optional[str] = None


@dataclasses.dataclass
class ProveReport:
    attempts: List[AttemptReport]

    @property
    def retried(self) -> bool:
        return len(self.attempts) > 1


def shard_checksums(prover: ShardedProver, full_assignment) -> torch.Tensor:
    """One wrapping 32-bit checksum per shard of the 4-lane G1 MSM
    partials: int64[S] in [0, 2^32), the same on every rank.

    Runs the witness map and each rank's Pippenger exactly as the sharded
    prove does, but keeps each rank's partial accumulator (no combine)
    and folds its digit words into one word; the words are all-gathered.
    The kernels are deterministic, so two calls disagreeing at shard i is
    evidence of a hardware fault on rank i."""
    dpk, c = prover.dpk, prover.c
    z = prover.encode_assignment(full_assignment)
    scalars4, _ = _g1_scalar_stack(prover.fr, prover.sntt, prover.mesh, prover.axis, dpk, z, dpk.num_inputs)
    acc = msm_device_lanes(codec.g1_ops(c), dpk.g1_msm_points, scalars4, c.r.bit_length())
    # wraparound sum of every digit word of the partial — enough to
    # witness any bit flip in the accumulator; summed in int64 (torch
    # promotes an int32 sum) and folded to a signed 32-bit word
    s = sum(x.to(torch.int64).sum() for x in acc) & 0xFFFFFFFF
    word = ((s + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    (words,) = all_gather_leaves([word.to(torch.int32).reshape(1)], prover.ax, "shard_checksums")
    return words.reshape(-1).cpu().to(torch.int64) & 0xFFFFFFFF


def localize_faults(prover: ShardedProver, full_assignment, passes: int = 2) -> List[int]:
    """Shard indices whose MSM-partial checksum is not reproducible
    across `passes` executions (empty on healthy hardware)."""
    runs = [shard_checksums(prover, full_assignment).tolist() for _ in range(max(2, passes))]
    base = runs[0]
    return sorted({i for r in runs[1:] for i, (x, y) in enumerate(zip(base, r)) if x != y})


class ElasticProver:
    """Sharded prover with verify-every-proof detection and shrink-mesh
    retry.  `prove_checked` returns (proof, report); the proof satisfies
    the Groth16 verify equation for the public inputs carried in
    `full_assignment`.

    ranks: the ranks that prove at first (default: the whole default
    group), a shrink keeps the first half; every rank of the default
    group constructs it and calls prove_checked.  device: this rank's
    device."""

    def __init__(
        self,
        pk: ProvingKey,
        matrices: ConstraintMatrices,
        ranks: Optional[Sequence[int]] = None,
        axis: str = DATA_AXIS,
        max_attempts: int = 3,
        fault_hook: Optional[Callable[[int, Proof], Proof]] = None,
        device="cuda",
    ):
        self.pk = pk
        self.matrices = matrices
        self.axis = axis
        self.max_attempts = max_attempts
        self.fault_hook = fault_hook
        self.device = device
        world = dist.get_world_size()
        self.ranks = list(ranks) if ranks is not None else list(range(world))
        self.c = get_curve(pk.vk.curve)
        # every rank of the default group: the attempts' agreement and
        # the result's broadcast
        self.world = Mesh(np.arange(world), ("world",), device)
        self._pvk = None
        self._prover: Optional[ShardedProver] = None
        self._build(len(self.ranks))

    def _build(self, n_devices: int) -> None:
        """A prover on the first n_devices ranks (every rank builds the
        mesh; its members upload their shards of the key)."""
        self.n_devices = n_devices
        mesh = Mesh(np.asarray(self.ranks[:n_devices]), (self.axis,), self.device)
        self._prover = ShardedProver(self.pk, self.matrices, mesh=mesh, axis=self.axis) if mesh.member else None

    def _verify(self, proof: Proof, public_inputs: List[int]) -> bool:
        from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof

        if self._pvk is None:
            self._pvk = prepare_verifying_key(self.pk.vk)
        return verify_proof(self._pvk, proof, public_inputs)

    def _attempt(self, attempt, full_assignment, r, s, public_inputs):
        """(outcome, proof, error) of one attempt on this rank."""
        if self._prover is None:
            return OK, None, None  # outside the mesh: the members decide
        try:
            proof = self._prover.prove(full_assignment, r, s)
            if self.fault_hook is not None:
                proof = self.fault_hook(attempt, proof)
        except Exception as e:  # device loss / backend abort: retried on fewer ranks
            return RAISED, None, repr(e)
        if self._verify(proof, public_inputs):
            return OK, proof, None
        return BAD_PROOF, None, SELF_CHECK_FAILED

    def prove_checked(self, full_assignment, r: int, s: int):
        """Prove with detection + elastic retry; (Proof, ProveReport)."""
        num_inputs = self.matrices.num_instance_variables
        public_inputs = [x % self.c.r for x in full_assignment[1:num_inputs]]
        report = ProveReport(attempts=[])
        proof, failure = None, None
        for attempt in range(self.max_attempts):
            n_dev = self.n_devices
            outcome, got, error = self._attempt(attempt, full_assignment, r, s, public_inputs)
            worst = all_reduce_max(outcome, self.world.axis("world"))
            if worst == OK:
                report.attempts.append(AttemptReport(attempt, n_dev, ok=True))
                proof = got
                break
            if worst == RAISED:
                error = error or "a prove raised on another rank"
            else:
                error = error or SELF_CHECK_FAILED
            report.attempts.append(AttemptReport(attempt, n_dev, ok=False, error=error))
            if worst == RAISED:
                if n_dev == 1:
                    failure = f"prove failed on the last device: {error}"
                    break
                self._build(max(1, n_dev // 2))
            elif len(report.attempts) >= 2 and not report.attempts[-2].ok and n_dev > 1:
                # same mesh is fine for transient SDC; a second failure on
                # the same shape shrinks
                self._build(max(1, n_dev // 2))
        else:
            failure = f"no valid proof after {self.max_attempts} attempts: " + "; ".join(
                a.error or "?" for a in report.attempts
            )
        # the first rank's result, on every rank
        out = [(proof, report, failure)]
        dist.broadcast_object_list(out, src=self.ranks[0])
        proof, report, failure = out[0]
        if failure is not None:
            raise ProverFaultError(failure)
        return proof, report
