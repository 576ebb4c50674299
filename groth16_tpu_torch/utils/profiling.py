"""Phase timers (the ark_std start_timer!/end_timer! analog of the
reference prover, prover.rs:35-125), the program's span recorder, its
counters, and speed-of-light operation counts.

Port of `PhaseTimer` and the speed-of-light helpers of
`groth16_tpu/utils/profiling.py`.  PyTorch returns before the card
finishes, so on a CUDA device every phase is fenced with
`torch.cuda.synchronize()` at its start and its end.

`span(name, timer)` is the one way the program marks a phase or a layer:
with a PhaseTimer it fences and times as `timer.phase(name)`; inside
`with tracing() as rec:` it also records (name, start_ns, end_ns,
parent, proof) in `rec.spans`, without a fence, on `time.time_ns()`, the
clock torch.profiler stamps host and device events on; otherwise it is a
shared null context.  Nothing is written anywhere: the spans and the
counters' deltas (`rec.counts`) are handed over when the block ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
import threading
import time
from typing import Dict, List

import torch


@dataclasses.dataclass
class PhaseTimer:
    """Nested scope timers; prints ark_std-style lines when verbose."""

    verbose: bool = True
    device: str = "cpu"
    records: List = dataclasses.field(default_factory=list)

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self.records.append((name, dt))
        if self.verbose:
            print(f"[timer] {name}: {dt:.3f}s", file=sys.stderr)

    def as_dict(self) -> Dict[str, float]:
        return {k: v for k, v in self.records}


# -- spans ---------------------------------------------------------------------

# the Recorder that `tracing` switched on, else None
_RECORDER = None
NULL_SPAN = contextlib.nullcontext()


class Recorder:
    """The spans of one `tracing` block: `spans`, a list of (name,
    start_ns, end_ns, parent, proof), where parent is the index of the
    span open around it on the same thread (None at a root) and proof the
    id of the job it belongs to: a root span takes that of the `job` block
    it is opened in, a child its parent's.  `counts`: the counters'
    change over the block (`counts_since`), once it has ended."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def _stack(self, key: str) -> list:
        return self._local.__dict__.setdefault(key, [])

    def open(self, name: str) -> int:
        stack = self._stack("spans")
        if stack:
            parent = stack[-1]
            proof = self.spans[parent][4]
        else:
            jobs = self._stack("jobs")
            parent, proof = None, (jobs[-1] if jobs else None)
        with self._lock:
            i = len(self.spans)
            self.spans.append([name, time.time_ns(), None, parent, proof])
        stack.append(i)
        return i

    def close(self, i: int) -> None:
        self.spans[i][2] = time.time_ns()
        self._stack("spans").pop()


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.open(self.name)

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return False


class _Job:
    __slots__ = ("rec", "proof")

    def __init__(self, rec: Recorder, proof):
        self.rec, self.proof = rec, proof

    def __enter__(self):
        if self.proof is None:
            self.proof = next(self.rec._ids)
        self.rec._stack("jobs").append(self.proof)
        return self.proof

    def __exit__(self, *exc):
        self.rec._stack("jobs").pop()
        return False


@contextlib.contextmanager
def _fenced(timer, rec: Recorder, name: str):
    with timer.phase(name), _Span(rec, name):
        yield


def span(name: str, timer=None):
    """A context that marks `name`: timed and fenced by `timer` (a
    PhaseTimer) where one is given, recorded where `tracing` is on, else
    the shared null context."""
    rec = _RECORDER
    if timer is None:
        return NULL_SPAN if rec is None else _Span(rec, name)
    return timer.phase(name) if rec is None else _fenced(timer, rec, name)


def job(proof=None):
    """A context for one job (one proof): the root spans opened in it on
    this thread carry its id, `proof` or the recorder's next number; ->
    the id (None where `tracing` is off)."""
    rec = _RECORDER
    return NULL_SPAN if rec is None else _Job(rec, proof)


@contextlib.contextmanager
def tracing():
    """Record the program's spans for the block: -> the Recorder, whose
    `spans` become tuples and whose `counts` are filled when the block
    ends."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("tracing is on already")
    rec = Recorder()
    before = snapshot()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
        rec.counts = counts_since(before)
        rec.spans = [tuple(s) for s in rec.spans]


# -- counters ------------------------------------------------------------------
#
# Each kernel module counts its own launches and plain-version calls in
# module dicts (LAUNCHES, PLAIN_CALLS; cuda_point's GENERAL_A_LAUNCHES;
# K1's and the group kernels' LAUNCH_SIZES and LARGEST_LAUNCH), and
# protocol/prover_torch.upload the bytes it sends to the device
# (TRANSFERS).  These read and reset them all.


def _counter_modules():
    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.fields import cuda_fp
    from groth16_tpu_torch.msm import cuda_scan
    from groth16_tpu_torch.protocol import prover_torch
    from groth16_tpu_torch.utils import ubench

    return cuda_fp, cuda_point, cuda_scan, ubench, prover_torch


def reset_counts() -> None:
    """Set every counter of this process to 0."""
    cuda_fp, cuda_point, cuda_scan, ubench, prover_torch = _counter_modules()
    dicts = [m.LAUNCHES for m in (cuda_fp, cuda_point, cuda_scan, ubench)]
    dicts += [m.PLAIN_CALLS for m in (cuda_fp, cuda_point, cuda_scan, ubench)]
    for m in (cuda_fp, cuda_point):
        dicts += [*m.LAUNCH_SIZES.values(), m.LARGEST_LAUNCH]
    dicts += [cuda_point.GENERAL_A_LAUNCHES, prover_torch.TRANSFERS]
    for d in dicts:
        for k in d:
            d[k] = 0


def snapshot() -> dict:
    """Copies of the counters: {"launches": kernel -> launches, "plain":
    kernel -> plain-version calls, "general_a": generic-a kernel and
    degree -> launches, "h2d_bytes": bytes uploaded}."""
    cuda_fp, cuda_point, cuda_scan, ubench, prover_torch = _counter_modules()
    out = {"launches": {}, "plain": {}}
    for m in (cuda_fp, cuda_point, cuda_scan, ubench):
        out["launches"].update(m.LAUNCHES)
        out["plain"].update(m.PLAIN_CALLS)
    out["general_a"] = dict(cuda_point.GENERAL_A_LAUNCHES)
    out["h2d_bytes"] = prover_torch.TRANSFERS["h2d_bytes"]
    return out


def counts_since(before: dict) -> dict:
    """snapshot() now less `before`, key by key."""
    def less(now, then):
        return now - then if isinstance(now, int) else {k: v - then.get(k, 0) for k, v in now.items()}

    return {k: less(v, before[k]) for k, v in snapshot().items()}


# -- speed-of-light models ------------------------------------------------------
#
# 32-bit multiply-adds of the limb engine's work, to divide by the card's
# rate of them (an IMAD does one).  The rate is the caller's: the card's
# measured one comes from utils/ubench.py (kernel V).  The JAX package
# counts 8 L^2 operations per product instead, adds and masks included,
# against a TPU rate: its VPU has no multiply-add.


def mont_mul_u32_ops(n_limbs: int) -> int:
    """One Montgomery product of L 15-bit digits (CIOS): the 2 L^2 digit
    products (a_i * b_j and m * p_j), each one multiply-add into a column,
    and the L products that derive m.  The masks, shifts and carries
    around them are left out, so a bound from this count is a floor."""
    return 2 * n_limbs * n_limbs + n_limbs


def mont_mul_word_ops(n_limbs: int) -> int:
    """One Montgomery product on the word engine (K1, csrc/field.cuh:
    mont_mul_words): W 32-bit words an operand, W rows of a_i * b and
    FULL + 1 reduction rows of m * p (FULL = floor(15 L / 32) full steps
    and the partial one), each row W products of two 32-bit multiplies
    (low and high halves), and the m of each reduction row.  Packing and
    carries left out, as in mont_mul_u32_ops."""
    from groth16_tpu_torch.fields.cuda_fp import KERNEL_WORDS

    W = KERNEL_WORDS[n_limbs]
    full = 15 * n_limbs // 32
    return 2 * W * W + (full + 1) * (2 * W + 1)


def point_add_u32_ops(n_limbs: int, fp2: bool = False, mixed: bool = True) -> int:
    """One complete a = 0 point addition: 13 field products for the mixed
    (projective + affine) one, 12 for the full one, each 4 base-field
    products over Fq2."""
    products = (13 if mixed else 12) * (4 if fp2 else 1)
    return products * mont_mul_u32_ops(n_limbs)


def point_add_word_ops(n_limbs: int, fp2: bool = False, mixed: bool = True) -> int:
    """point_add_u32_ops on the word engine: the same 13 (mixed) or 12
    field products, x4 over Fq2, each mont_mul_word_ops."""
    products = (13 if mixed else 12) * (4 if fp2 else 1)
    return products * mont_mul_word_ops(n_limbs)


# A product by a constant below 2^8 in magnitude (mod p) is a few shifted
# additions, as the a = 0 count leaves b3 = 9 or 12 out: MNT's a (2, 11,
# 34) and the tower nonresidues (5, 17) are such constants.
SMALL_CONST = 1 << 8


def const_products(c, p: int) -> int:
    """Base-field products of one product of an Fq^deg element by the
    constant c (an int for Fq, else its deg coordinates): deg for each
    coordinate that is not small, so a monomial (MNT's twisted b3) costs
    deg; the nonresidue's wrap of the coordinates is additions."""
    coords = c if isinstance(c, tuple) else (c,)
    return len(coords) * sum(1 for x in coords if SMALL_CONST <= x % p <= p - SMALL_CONST)


def general_add_products(g) -> int:
    """Base-field products that one generic-a addition of curve ops g
    needs (RCB algorithm 1, MNT's a != 0; curves/cuda_point.add_general_plain):
    its 12 field products, deg^2 base-field products each over Fq^deg as
    in point_add_word_ops, and its 3 products by a and 2 by b3 at
    const_products.  MNT: 14 (G1), 52 (MNT4's G2), 114 (MNT6's G2)."""
    p, deg = g.k.spec.modulus, g.k.tower_deg
    return 12 * deg * deg + 3 * const_products(g.a_val, p) + 2 * const_products(g.b3_val, p)


def point_add_general_u32_ops(g) -> int:
    """One generic-a addition on 15-bit digits (point_add_u32_ops' count)."""
    return general_add_products(g) * mont_mul_u32_ops(g.k.spec.n_limbs)


def point_add_general_word_ops(g) -> int:
    """One generic-a addition on the word engine (point_add_word_ops'
    count): its products, each mont_mul_word_ops."""
    return general_add_products(g) * mont_mul_word_ops(g.k.spec.n_limbs)


def msm_work_point_adds(n: int, scalar_bits: int, window_bits: int, signed: bool = True) -> int:
    """Point additions of one Pippenger MSM of n points (the JAX package's
    count): the suffix scan adds n a window, the bucket tail ~2 a bucket
    (boundary add and reduce level), Horner window_bits doublings and one
    add a window.  Signed digits halve the buckets and add a carry window
    only where window_bits divides scalar_bits."""
    if signed:
        from groth16_tpu_torch.msm.pippenger import signed_num_windows

        windows = signed_num_windows(scalar_bits, window_bits)
    else:
        windows = -(-scalar_bits // window_bits)
    B = ((1 << (window_bits - 1)) + 1) if signed else (1 << window_bits)
    return windows * (n + 2 * B) + windows * (window_bits + 1)


def scalar_mul_steps(digits, c: int) -> list:
    """(doublings, additions) of each lane of the fixed-window scalar
    multiplication (csrc/horner.cu: scalar_mul_kernel) on c-bit window
    digits [lanes, windows] (window 0 first, cuda_point.window_digits):
    the table's 2^(c - 1) - 1 of each, then below the top non-zero digit c
    doublings a window and an addition a non-zero digit."""
    table = (1 << (c - 1)) - 1
    out = []
    for row in digits.tolist():
        nz = [w for w, d in enumerate(row) if d]
        top = nz[-1] if nz else 0
        out.append((table + top * c, table + len(nz[:-1])))
    return out


def ntt_butterflies(n: int) -> int:
    """Butterflies of one radix-2 NTT of size n: n/2 a stage, log2 n stages."""
    return (n // 2) * max(1, (n - 1).bit_length())
