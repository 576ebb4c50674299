"""CUDA kernels K2/K3 — the MSM suffix scans — and their plain version.

Counterpart of `groth16_tpu/msm/pallas_scan.py`:

  suffix_scan_g1_rows  K2  replaces pallas_scan.suffix_scan_g1_rows
  suffix_scan_g2_rows  K3  replaces pallas_scan.suffix_scan_g2_rows

A scan of R rows, C chunks and K steps cuts each (row, chunk) column's
steps into S contiguous segments of ceil(K/S) steps (the last may be
shorter) and runs one thread per (row, segment, chunk)
(csrc/suffix_scan.cu):

  S = 1   one launch: each thread carries its column's accumulator
          through all K steps in registers and writes every prefix row;
  S > 1   reduce then scan: a first launch writes each segment's total;
          the carries (the sum of the segments above each one) come from
          a Hillis-Steele scan of full adds (K4/K5, `curves/cuda_point.py`);
          a second launch rescans every segment from its carry and writes
          the prefix rows.

S is chosen from the card (`scan_segments`, `choose_segments`): 1 when
the R*C columns give every SM a block, else as many segments as keep
MIN_SEGMENT_STEPS steps each.  The layout is the JAX package's:

  rows    int32[R, K*C, 2*ce]  element-major affine x || y (ce = L for
          G1, 2L for G2, tower-major: x0 digits then x1 digits); storage
          index k*C + c holds step k of chunk c; affine infinity is
          (0, 0); the signed digit's sign rides in bit 31 of x's digit 0;
  prefix  int32[R, K*C, 3*ce]  X || Y || Z at (k, c) = sum of steps
          k..K-1 of chunk c (inclusive suffix);
  totals  (X, Y, Z), each [L, R, C] (G1) or [L, 2, R, C] (G2) — the chunk
          sums, limb-major.

A set sign bit negates y as 2p - y; infinity rows keep (0, 0) and leave
the accumulator as it is.  Each step is the mixed addition of K6/K7 and
each carry the full addition of K4/K5, so the plain version below, which
takes the same S and adds in the same order, gives the same digits for
every S (different S give the same points in other digits).  Each
wrapper dispatches by device only: CPU tensors run the plain version
(S = 1 unless `segments` is given), CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from groth16_tpu_torch.curves.cuda_point import (
    _plain_ops,
    add_g1,
    add_g2,
    add_plain,
    mixed_add_plain,
)
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.cuda_fp import KERNEL_LIMBS, kernel_consts
from groth16_tpu_torch.fields.spec import FpSpec, int_to_limbs

# launches per kernel, counted where the kernel is launched and nowhere else
LAUNCHES = {"suffix_scan_g1": 0, "suffix_scan_g2": 0}
# calls of the plain version on CUDA tensors (the main path makes none)
PLAIN_CALLS = {"suffix_scan_g1": 0, "suffix_scan_g2": 0}

# bit 31 of x's digit 0 (as int32): the sorted signed digit's sign
SIGN_BIT = -(1 << 31)

# Threads a block of the scan kernel (kThreads in csrc/suffix_scan.cu).
SCAN_THREADS = 64
# Steps the segment chooser gives a segment.  More segments shorten the
# dependent chain a thread runs, but their carries cost log2 S rounds of
# full adds over R*C*S points whether the rows are dense or nearly all
# infinity (as much of a Groth16 key is).  On an H100 the 2^20 bls12_381
# prove (chip_smoke.py's sweep) took the same time within its spread at
# 32-128 steps a segment (S = 32 down to 8 at K = 1,024), more at 16 and
# far more at S = 1; 64 steps lies between: 16% faster than 128 on dense
# rows, 22-30% faster than 32 on the key's sparse ones.
MIN_SEGMENT_STEPS = 64


def _lib(n_limbs: int, deg: int, nr: int):
    from groth16_tpu_torch.utils.cuda_build import library, suffix_scan_variant

    lib = library(suffix_scan_variant(n_limbs, deg, nr))
    if not getattr(lib, "_g16_typed", False):
        P, LL = ctypes.c_void_p, ctypes.c_longlong
        lib.g16_suffix_scan.argtypes = [P] * 8 + [LL] * 4 + [P, ctypes.c_uint, P]
        lib.g16_suffix_scan.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def segment_steps(K: int, segments: int):
    """(S, steps per segment) for K steps cut into `segments` pieces: a
    segment holds ceil(K/segments) steps, and S counts the non-empty
    ones (at most K)."""
    seg = -(-K // max(1, min(segments, K)))
    return -(-K // seg), seg


def choose_segments(columns: int, K: int, sms: int) -> int:
    """S for `columns` columns of K steps on a card of `sms` SMs.
    Segments double the additions (a reduce and a scan pass), so they pay
    only for SMs the columns leave idle: S = 1 once every SM holds a block
    (sms * SCAN_THREADS columns), else K // MIN_SEGMENT_STEPS.  1 on the
    CPU (no SMs)."""
    if columns <= 0 or columns >= sms * SCAN_THREADS:
        return 1
    return max(1, K // MIN_SEGMENT_STEPS)


def scan_segments(R: int, K: int, C: int, device, segments=None) -> int:
    """The S a wrapper runs with: `segments` where given (tests and
    chip_smoke.py), else `choose_segments` for the card's SMs (none on
    the CPU, so S = 1 there); never more segments than non-empty ones."""
    device = torch.device(device)
    if K == 0:
        return 1
    if segments is None:
        sms = 0
        if device.type == "cuda":
            sms = torch.cuda.get_device_properties(device).multi_processor_count
        segments = choose_segments(R * C, K, sms)
    return segment_steps(K, segments)[0]


def _carries(add, k, totals, R: int, S: int, C: int):
    """carry_s = total_{s+1} + ... + total_{S-1} for each (row, chunk),
    from the segment totals (each [*cs, R*S*C], thread order (r, s, c)):
    a Hillis-Steele inclusive suffix scan of totals 1..S-1, ceil(log2(S-1))
    full adds `add`, and the identity for the top segment.  Returns
    contiguous [*cs, R*S*C] planes."""
    cs = tuple(totals[0].shape[:-1])
    pts = [x.reshape(cs + (R, S, C))[..., 1:, :] for x in totals]
    m, d = S - 1, 1
    while d < m:
        lo = [x[..., : m - d, :].reshape(cs + (-1,)).contiguous() for x in pts]
        hi = [x[..., d:, :].reshape(cs + (-1,)).contiguous() for x in pts]
        head = [x.reshape(cs + (R, m - d, C)) for x in add(lo, hi)]
        pts = [torch.cat([h, x[..., m - d :, :]], dim=-2) for h, x in zip(head, pts)]
        d *= 2
    dev = totals[0].device
    top = (R, 1, C)
    ident = (k.zero(top, device=dev), k.one(top, device=dev), k.zero(top, device=dev))
    return [torch.cat([x, i], dim=-2).reshape(cs + (R * S * C,)) for x, i in zip(pts, ident)]


def _scan(spec: FpSpec, nr, b3_val, rows: torch.Tensor, K: int, C: int, segments):
    D = 1 if nr is None else 2
    name = f"suffix_scan_g{D}"
    L = spec.n_limbs
    if rows.dim() != 3 or rows.shape[1] != K * C or rows.shape[2] != 2 * D * L:
        raise ValueError(
            f"{name}: expected rows [R, {K}*{C}, {2 * D * L}], got {tuple(rows.shape)}"
        )
    R = rows.shape[0]
    if rows.device.type == "cpu":
        S = scan_segments(R, K, C, rows.device, segments)
        return suffix_scan_plain(_plain_ops(spec, nr), b3_val, rows, K, C, S)
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rows.device}")
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 digits, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows are not contiguous")
    if L not in KERNEL_LIMBS:
        raise ValueError(f"{name}: no kernel for L = {L} (have {KERNEL_LIMBS})")
    if D == 2 and not 1 <= abs(nr) <= 16:
        raise ValueError(f"{name}: no kernel for Fq2 nonresidue {nr}")
    dev = rows.device
    lead = (L,) if D == 1 else (L, 2)
    prefix = torch.empty((R, K * C, 3 * D * L), dtype=torch.int32, device=dev)
    totals = [torch.empty(lead + (R * C,), dtype=torch.int32, device=dev) for _ in range(3)]
    if R * C * K:
        S = scan_segments(R, K, C, dev, segments)
        lib = _lib(L, D, 0 if nr is None else nr)
        consts = kernel_consts(spec, b3_val, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(pre, carry, out):
            carry_ptrs = [None] * 3 if carry is None else [x.data_ptr() for x in carry]
            rc = lib.g16_suffix_scan(
                rows.data_ptr(), pre, *carry_ptrs, *[x.data_ptr() for x in out], R, K, C, S,
                consts.data_ptr(), spec.n0inv, stream,
            )
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
            LAUNCHES[name] += 1

        carry = None
        if S > 1:
            seg_totals = [
                torch.empty(lead + (R * S * C,), dtype=torch.int32, device=dev) for _ in range(3)
            ]
            launch(None, None, seg_totals)
            if D == 1:
                add = functools.partial(add_g1, spec, b3_val)
            else:
                add = functools.partial(add_g2, spec, nr, b3_val)
            carry = _carries(add, _plain_ops(spec, nr), seg_totals, R, S, C)
        launch(prefix.data_ptr(), carry, totals)
    return prefix, tuple(t.reshape(lead + (R, C)) for t in totals)


def suffix_scan_g1_rows(
    spec: FpSpec, b3_val: int, rows: torch.Tensor, K: int, C: int, segments=None
):
    """K2: within-chunk suffix scan over gathered affine G1 rows [R, K*C,
    2L].  Returns (prefix [R, K*C, 3L], totals (X, Y, Z) each [L, R, C]).
    `segments` fixes S (tests and chip_smoke.py); by default the card
    chooses it (`scan_segments`)."""
    return _scan(spec, None, b3_val, rows, K, C, segments)


def suffix_scan_g2_rows(
    spec: FpSpec, nr: int, b3_val, rows: torch.Tensor, K: int, C: int, segments=None
):
    """K3: K2 over Fq2 coordinates, rows [R, K*C, 4L] (x0 || x1 || y0 ||
    y1).  Returns (prefix [R, K*C, 6L], totals each [L, 2, R, C])."""
    return _scan(spec, nr, b3_val, rows, K, C, segments)


# -- plain version ---------------------------------------------------------------


def suffix_scan_plain(k, b3_val, rows: torch.Tensor, K: int, C: int, segments: int = 1):
    """Plain version of K2/K3 with the kernel's S segments and order: each
    (row, segment, chunk) lane runs its steps from the segment's top down
    as one step of the plain mixed addition (a step past a short last
    segment's end adds infinity); for S > 1 a first run gives the segment
    totals, `_carries` over the plain full addition their carries, and a
    second run from the carries writes each step's accumulator into the
    prefix.  k: the plain FpOps / Fp2Ops."""
    spec = k.spec
    L = spec.n_limbs
    D = k.tower_deg
    ce = D * L
    R = rows.shape[0]
    dev = rows.device
    if rows.is_cuda:
        PLAIN_CALLS[f"suffix_scan_g{D}"] += 1
    cs = (L,) if D == 1 else (L, D)
    S, seg = segment_steps(K, segments) if K else (1, 0)
    n = R * S * C
    sign = (rows[..., 0] < 0).reshape(R, K, C)  # bit 31 set
    body = rows.clone()
    body[..., 0] &= 0x7FFFFFFF
    steps = body.reshape(R, K, C, 2 * ce)
    twop = torch.tensor(int_to_limbs(2 * spec.modulus, L), dtype=torch.int32, device=dev)
    twop = twop.reshape((L,) + (1,) * D)
    lo = torch.arange(S, device=dev) * seg
    hi = torch.clamp(lo + seg, max=K)

    def coord(block):  # [R, S, C, ce] tower-major -> [*cs, n]
        x = block.reshape(n, D, L).permute(2, 1, 0)
        return (x[:, 0] if D == 1 else x).contiguous()

    def rows_of(x):  # [*cs, n] -> [R, S, C, ce] tower-major
        return x.reshape(L, D, n).permute(2, 1, 0).reshape(R, S, C, ce)

    def run(acc, prefix):
        for i in range(seg):
            kk = hi - 1 - i
            live = kk >= lo  # [S]
            kk = torch.clamp(kk, min=0)
            block = steps[:, kk]  # [R, S, C, 2*ce]
            x2, y2 = coord(block[..., :ce]), coord(block[..., ce:])
            live_n = live[:, None].expand(R, S, C).reshape(n)
            y2 = torch.where(live_n, y2, torch.zeros_like(y2))
            inf2 = torch.all((y2 == 0).reshape(ce, n), dim=0)
            neg = sign[:, kk].reshape(n) & ~inf2
            y2 = torch.where(neg, fp.sub_exact(spec, twop, y2, k=0), y2)
            acc = mixed_add_plain(k, b3_val, acc, (x2, y2))
            if prefix is not None:
                out = torch.cat([rows_of(x) for x in acc], dim=-1)
                prefix.view(R, K, C, 3 * ce)[:, kk[live]] = out[:, live]
        return acc

    identity = (k.zero((n,), device=dev), k.one((n,), device=dev).contiguous(),
                k.zero((n,), device=dev))
    carry = identity
    if S > 1:
        seg_totals = run(identity, None)
        add = functools.partial(add_plain, k, b3_val)
        carry = tuple(_carries(add, k, seg_totals, R, S, C))
    prefix = torch.empty((R, K * C, 3 * ce), dtype=torch.int32, device=dev)
    acc = run(carry, prefix)
    return prefix, tuple(x.reshape(cs + (R, S, C))[..., 0, :].contiguous() for x in acc)
