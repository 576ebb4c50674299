"""Scans and reductions over point batches (PyTorch).

Port of `groth16_tpu/msm/scans.py`.  Each `lax.scan` / `fori_loop` of the
JAX version is a Python loop over point-add launches here (K4/K5 for
projective adds, K6/K7 for the mixed adds of the capture scan, the MSM
path taken with `msm_fused_scan=False`; where a != 0 the generic-a group
kernel's capture step, one launch a step), with the same chunking, so
the work stays ~N adds:

  - within-chunk pass: view the [N] element axis as [C, K] and step
    along K (K sequential C-wide adds);
  - cross-chunk pass: Hillis-Steele over the C chunk totals.

All helpers take (X, Y, Z) point tuples and a CurveDevice `g`;
coordinate axes LEAD and the element axis is the TRAILING axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from groth16_tpu_torch.curves.point import CurveDevice, Point


def ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length()) if n > 1 else 0


def _roll(pt: Point, shift: int) -> Point:
    return tuple(torch.roll(x, shift, dims=-1) for x in pt)


def hs_scan(g: CurveDevice, pts: Point, reverse: bool = False) -> Point:
    """Inclusive Hillis-Steele scan over the element axis of a [C] batch:
    ceil(log2(C)) adds of width C."""
    C = pts[2].shape[-1]
    if C == 1:
        return pts
    dev = pts[0].device
    pos = torch.arange(C, device=dev)
    inf = g.infinity(g.batch_shape(pts), device=dev)
    buf = pts
    for k in range(ceil_log2(C)):
        s = 1 << k
        if reverse:
            shifted = _roll(buf, -s)
            valid = pos + s < C
        else:
            shifted = _roll(buf, s)
            valid = pos >= s
        buf = g.add(buf, g.select(valid, shifted, inf))
    return buf


def _pick_chunks(N: int, max_chunks: int) -> int:
    """Chunk count balancing the K-step within pass (work N) against the
    Hillis-Steele cross pass (work C*log2(C) — keep it o(N))."""
    C = min(max_chunks, max(8, N // 8))
    while N % C:
        C -= 1
    return C


def chunk_scan_parts(
    g: CurveDevice, pts: Point, reverse: bool = False, max_chunks: int = 4096
) -> Tuple[Point, Point, int]:
    """Two-level inclusive scan decomposition of an [N] point batch.

    Returns (within [.., C, K], cross_excl [.., C], K) with N = K*C such
    that scan(pts)[j] = within[.., j // K, j % K] + cross_excl[.., j // K];
    cross_excl[.., c] is the total of all chunks strictly before (after,
    if reverse) chunk c."""
    N = pts[2].shape[-1]
    C = _pick_chunks(N, max_chunks)
    K = N // C
    dev = pts[0].device
    lead = g.batch_shape(pts)[:-1]
    # [.., N] -> [K, .., C]: chunk c = elements [c*K, (c+1)*K)
    rows = tuple(x.reshape(tuple(x.shape[:-1]) + (C, K)).movedim(-1, 0) for x in pts)
    acc = g.infinity(lead + (C,), device=dev)
    within = [None] * K
    for k in (reversed(range(K)) if reverse else range(K)):
        acc = g.add(acc, tuple(r[k] for r in rows))
        within[k] = acc
    within = tuple(torch.stack([w[i] for w in within], dim=-1) for i in range(3))
    if C > 512:
        # recurse: a Hillis-Steele over thousands of chunks costs log2(C)
        # full-width steps; a second two-level scan does it in fewer
        cross_incl = scan_points(g, acc, reverse=reverse, max_chunks=512)
    else:
        cross_incl = hs_scan(g, acc, reverse=reverse)
    pos = torch.arange(C, device=dev)
    if reverse:
        cross_excl = _roll(cross_incl, -1)
        mask = pos < C - 1
    else:
        cross_excl = _roll(cross_incl, 1)
        mask = pos >= 1
    cross_excl = g.select(mask, cross_excl, g.infinity(lead + (C,), device=dev))
    return within, cross_excl, K


def scan_points(
    g: CurveDevice, pts: Point, reverse: bool = False, max_chunks: int = 4096
) -> Point:
    """Full inclusive scan (the recursive cross pass of chunk_scan_parts)."""
    N = pts[2].shape[-1]
    within, cross_excl, K = chunk_scan_parts(g, pts, reverse=reverse, max_chunks=max_chunks)
    out = g.add(within, tuple(x[..., None] for x in cross_excl))
    # [.., C, K] -> [.., N] with element j = c*K + k
    return tuple(x.reshape(tuple(x.shape[:-2]) + (N,)) for x in out)


def scan_storage_mixed_capture(g: CurveDevice, xy_T, K: int, C: int,
                               jk: torch.Tensor, jc: torch.Tensor,
                               reverse: bool = False):
    """Within-chunk inclusive scan in STEP-MAJOR storage over AFFINE rows
    (infinity encoded (0, 0)), CAPTURING only T requested positions.

    xy_T leaves: [*coords, *lead, N] with N = K*C where storage index
    k*C + c holds position k of chunk c.  Step k is one C-wide mixed add
    (K6/K7 on the card).  jk/jc: int[*lead, T] — capture target t wants
    the inclusive scan value of chunk jc[t] at within-chunk position
    jk[t].  Returns (captured [.., T] projective, chunk totals [.., C])."""
    x_T, y_T = xy_T
    cd = g.k.coord_ndim
    cs = tuple(x_T.shape[:cd])
    lead = tuple(x_T.shape[cd:-1])
    T = jk.shape[-1]
    dev = x_T.device
    # one copy puts each step's C-wide row in contiguous memory
    rows = tuple(
        x.reshape(cs + lead + (K, C)).movedim(-2, 0).contiguous() for x in (x_T, y_T)
    )
    if not g.a_is_zero:
        return _capture_steps(g, rows, K, C, jk, jc, reverse)
    lead_iotas = tuple(
        torch.arange(d, device=dev).reshape((1,) * i + (d,) + (1,) * (len(lead) - i))
        for i, d in enumerate(lead)
    )
    jc = jc.long()
    acc = g.infinity(lead + (C,), device=dev)
    cap = g.infinity(lead + (T,), device=dev)
    for i in range(K):
        k = K - 1 - i if reverse else i
        acc = g.add_affine(acc, (rows[0][k], rows[1][k]))
        # capture acc[.., jc[t]] where jk[t] == k (inclusive: after the add)
        acc_at = tuple(x[(Ellipsis,) + lead_iotas + (jc,)] for x in acc)
        cap = g.select(jk == k, acc_at, cap)
    return cap, acc


def _capture_steps(g: CurveDevice, rows, K: int, C: int, jk, jc, reverse: bool):
    """scan_storage_mixed_capture where a != 0, on flat points: step k is
    one capture step (CurveDevice.capture_step: the row added, and the
    captures of the step before copied from its input, in one launch of
    the generic-a group kernel), one capture after the last step."""
    cs = tuple(rows[0].shape[1 : 1 + g.k.coord_ndim])
    lead = tuple(rows[0].shape[1 + g.k.coord_ndim : -1])
    nl = math.prod(lead)
    T = jk.shape[-1]
    dev = rows[0].device
    # flat capture target i T + t of lead entry i reads accumulator i C + jc
    base = (torch.arange(nl, device=dev) * C).reshape(lead + (1,))
    src = (base + jc.long()).reshape(-1).to(torch.int32).contiguous()
    jkf = jk.reshape(-1).to(torch.int32).contiguous()
    acc = g.infinity((nl * C,), device=dev)
    cap = g.infinity((nl * T,), device=dev)
    k_prev = -1
    for i in range(K):
        k = K - 1 - i if reverse else i
        xy = tuple(r[k].reshape(cs + (nl * C,)) for r in rows)
        acc, cap = g.capture_step(acc, xy, cap, jkf, src, k_prev)
        k_prev = k
    _, cap = g.capture_step(acc, None, cap, jkf, src, k_prev, add=False)
    return (tuple(x.reshape(cs + lead + (T,)) for x in cap),
            tuple(x.reshape(cs + lead + (C,)) for x in acc))


def reduce_points(g: CurveDevice, pts: Point) -> Point:
    """Sum an [N] point batch to a single point: K contiguous-slice
    accumulation steps to C partials, then recurse (Hillis-Steele once
    small)."""
    N = pts[2].shape[-1]
    if N <= 64:
        return g.index(hs_scan(g, pts, reverse=True), 0)
    C = min(1024, max(8, N // 8))
    while N % C:
        C -= 1
    K = N // C
    acc = g.infinity(g.batch_shape(pts)[:-1] + (C,), device=pts[0].device)
    for i in range(K):
        acc = g.add(acc, tuple(x[..., i * C : (i + 1) * C] for x in pts))
    return reduce_points(g, acc)
