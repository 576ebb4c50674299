"""Variable-base multi-scalar multiplication on the device (PyTorch).

Port of `groth16_tpu/msm/pippenger.py`.  Per c-bit window w:

  1. digit_i = bits [cw, cw+c) of scalar_i (standard-form 15-bit limbs),
     recoded to signed digits in [-2^(c-1), 2^(c-1)] (one extra carry
     window only when c divides the scalar bits);
  2. sort point indices by digit: int64 keys (digit << shift) | (sign <<
     idx_bits) | index, the packed layout of the JAX version, which
     int64 always has room for, so the sorted keys are the gather index;
  3. two-level suffix scan of mixed adds over the gathered affine rows,
     and the B-1 bucket-boundary values G_v = sum of points with digit
     >= v taken from it;
  4. Pippenger identity sum_d d*S_d = sum_{v=1}^{B-1} G_v;
  5. window_sum = reduce(G_1..G_{B-1}); Horner: res = 2^c * res + w_sum,
     every window of every lane in one launch (`CurveDevice.horner`).

Step 3 runs one of two paths, chosen by `fused_scan_ok` as in the JAX
package: `CONFIG.msm_fused_scan` where the curve has a scan kernel (a = 0
over Fq or Fq2; MNT's a != 0 and Fq3 take the capture path):

  fused (default)  one launch of the suffix-scan kernel K2/K3
                   (msm/cuda_scan.py) per window group writes every
                   prefix value; the sign rides in bit 31 of the rows;
                   the boundaries come from a digit histogram
                   (first_ge_histogram) and are gathered from the prefix;
  capture          K Python steps of one C-wide mixed add (K6/K7; where
                   a != 0 the generic-a full addition of the rebuilt
                   projective point) each,
                   capturing the boundary values in flight at positions
                   from a batched searchsorted on the sorted keys
                   (msm/scans.py); negation rides the gather index into
                   a second y-negated copy of the rows.

Windows run in groups as an extra batch dimension (sized by a memory
budget), and `msm_device_lanes` runs several MSMs as lanes of one pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from groth16_tpu_torch.config import CONFIG
from groth16_tpu_torch.curves.point import CurveDevice, Point
from groth16_tpu_torch.fields.spec import LIMB_BITS
from groth16_tpu_torch.msm.cuda_scan import SIGN_BIT, suffix_scan_g1_rows, suffix_scan_g2_rows
from groth16_tpu_torch.msm.scans import (
    _pick_chunks,
    _roll,
    reduce_points,
    scan_points,
    scan_storage_mixed_capture,
)

# Per-bucket tail weight of the window chooser against one suffix-scan
# point add: the JAX package's values (`msm_bucket_cost` on its fused path,
# `_bucket_cost` on its capture path), both fitted on a TPU.
FUSED_BUCKET_COST = 2
CAPTURE_BUCKET_COST = 50
# Chunk-count cap of the fused scan (the JAX package's
# `msm_max_chunks_fused`): C sets the scan's column count (R*C threads of
# K = npad/C steps each) and the width of the cross pass.
FUSED_MAX_CHUNKS = 512


def fused_scan_ok(g: CurveDevice) -> bool:
    """Whether the MSMs of curve ops g take the fused scan (K2/K3):
    `CONFIG.msm_fused_scan` and a = 0 with Fq or Fq2 coordinates, |nr| <=
    16 (the JAX package's `_fused_scan_ok`, groth16_tpu/msm/pippenger.py:61);
    MNT's a != 0 and Fq3 run the capture path."""
    k = g.k
    return CONFIG.msm_fused_scan and g.a_is_zero and (
        k.tower_deg == 1 or (k.tower_deg == 2 and 1 <= abs(k.nr_int) <= 16)
    )


def signed_num_windows(scalar_bits: int, c: int) -> int:
    """Window count for the signed-digit recode: the carry window is real
    only when c divides scalar_bits."""
    W = -(-scalar_bits // c)
    return W + (1 if W * c == scalar_bits else 0)


def choose_window_bits(
    n: int, scalar_bits: int, signed: bool = False, bucket_cost: int = FUSED_BUCKET_COST
) -> int:
    """Minimize windows*(n + bucket_cost*buckets) over c in [4, 16]."""
    best_c, best_cost = 4, None
    for c in range(4, 17):
        windows = signed_num_windows(scalar_bits, c) if signed else -(-scalar_bits // c)
        buckets = (1 << (c - 1)) if signed else (1 << c)
        cost = windows * (n + bucket_cost * buckets)
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def first_ge_histogram(digits: torch.Tensor, B: int) -> torch.Tensor:
    """first_ge[.., v] = #(digits < v+1) for v in 0..B-2: the first sorted
    position with digit >= v+1, from a histogram of the raw digits (no
    dependency on the sort).  The JAX package contracts one-hots on the
    TPU's matrix unit; here one `scatter_add_` of exact int64 counts.

    digits: int[.., N] window magnitudes (< B).  Returns int64[.., B-1]."""
    lead = tuple(digits.shape[:-1])
    d = digits.reshape(-1, digits.shape[-1]).long()
    hist = torch.zeros((d.shape[0], B), dtype=torch.int64, device=d.device)
    hist.scatter_add_(1, d, torch.ones_like(d))
    return torch.cumsum(hist, dim=-1)[:, : B - 1].reshape(lead + (B - 1,))


def window_digits(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """Bits [c*w, c*w + c) of int32[Ls, *batch] 15-bit-limb scalars."""
    b0 = c * w
    i0, sh = divmod(b0, LIMB_BITS)
    Ls = scalars.shape[0]
    lo = scalars[i0] >> sh if i0 < Ls else torch.zeros_like(scalars[0])
    if sh + c > LIMB_BITS and i0 + 1 < Ls:
        lo = lo | (scalars[i0 + 1] << (LIMB_BITS - sh))
    return lo & ((1 << c) - 1)


def all_window_digits(scalars: torch.Tensor, c: int, scalar_bits: int) -> torch.Tensor:
    """[num_windows, *batch] digit matrix."""
    return torch.stack(
        [window_digits(scalars, c, w) for w in range(-(-scalar_bits // c))], dim=0
    )


def signed_window_digits(scalars: torch.Tensor, c: int, scalar_bits: int):
    """Signed-digit recode: scalar = sum_w (-1)^{s_w} m_w 2^{cw} with
    magnitudes m_w in [0, 2^(c-1)].  Returns (mags, signs), each
    [signed_num_windows(sb, c), *batch] int32."""
    num_raw = -(-scalar_bits // c)
    total = signed_num_windows(scalar_bits, c)
    half = 1 << (c - 1)
    full = 1 << c
    carry = torch.zeros_like(scalars[0])
    mags, signs = [], []
    for w in range(num_raw):
        d = window_digits(scalars, c, w) + carry  # <= 2^c
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        signs.append(neg.to(torch.int32))
        carry = neg.to(torch.int32)
    if total > num_raw:
        mags.append(carry)
        signs.append(torch.zeros_like(carry))
    return torch.stack(mags, dim=0), torch.stack(signs, dim=0)


def _pad_size(n: int) -> int:
    if n <= 4096:
        m = 8
        while m < n:
            m <<= 1
        return m
    return -(-n // 4096) * 4096


class MsmPlan(NamedTuple):
    """The shapes of one msm_device_lanes call."""

    fused: bool  # fused scan (K2/K3) or capture scan (K6/K7)
    c: int  # window bits
    num_windows: int
    B: int  # digit magnitudes 0..B-1, so B-1 bucket boundaries
    npad: int  # points per lane after padding
    C: int  # chunks of the suffix scan
    K: int  # steps per chunk (npad = K*C)
    wg: int  # windows per group
    n_groups: int


def msm_plan(g: CurveDevice, n: int, lanes: int, scalar_bits: int, window_bits=None) -> MsmPlan:
    """Windows, padding, chunking and window groups for `lanes` MSMs of n
    points of curve ops g, on the scan path `fused_scan_ok(g)`."""
    fused = fused_scan_ok(g)
    ce = g.k.spec.n_limbs * g.k.tower_deg
    signed = CONFIG.msm_signed_digits
    bucket_cost = FUSED_BUCKET_COST if fused else CAPTURE_BUCKET_COST
    c = window_bits or CONFIG.msm_window_bits or choose_window_bits(
        n, scalar_bits, signed, bucket_cost
    )
    if signed:
        num_windows, B = signed_num_windows(scalar_bits, c), (1 << (c - 1)) + 1
    else:
        num_windows, B = -(-scalar_bits // c), 1 << c
    npad = _pad_size(n)
    C = _pick_chunks(npad, FUSED_MAX_CHUNKS if fused else CONFIG.msm_max_chunks)
    # the gathered point copies of one window: affine rows (2 ce words a
    # point) and, on the fused path, the projective prefix (3 ce)
    words = 5 * ce if fused else 3 * ce
    bytes_per_window = lanes * npad * words * 4
    wg = max(1, min(num_windows, CONFIG.msm_group_bytes // max(1, bytes_per_window)))
    n_groups = -(-num_windows // wg)
    wg = -(-num_windows // n_groups)  # balanced: the last group is not mostly padding
    return MsmPlan(fused, c, num_windows, B, npad, C, npad // C, wg, n_groups)


def msm_device(
    g: CurveDevice,
    points: Point,
    scalars: torch.Tensor,
    scalar_bits: int,
    window_bits: int | None = None,
) -> Point:
    """MSM(points, scalars) -> single projective point.  points: (X, Y, Z)
    batch of N affine-uploaded points (Z = 1, infinity Z = 0); scalars:
    int32[Ls, N] standard-form 15-bit limbs."""
    out = msm_device_lanes(
        g, tuple(x[..., None, :] for x in points), scalars[None], scalar_bits, window_bits
    )
    return tuple(x[..., 0] for x in out)


def msm_device_lanes(
    g: CurveDevice,
    points: Point,
    scalars: torch.Tensor,
    scalar_bits: int,
    window_bits: int | None = None,
) -> Point:
    """`lanes` independent MSMs in one batched pass.  points: leaves
    [*coords, lanes, N]; scalars: int32[lanes, Ls, N].  Returns points
    with batch (lanes,)."""
    lanes, Ls, n = scalars.shape
    assert g.batch_shape(points) == (lanes, n)
    dev = scalars.device
    signed = CONFIG.msm_signed_digits
    cs = g.k.coord_shape()
    L = g.k.spec.n_limbs
    D = g.k.tower_deg
    ce = L * D
    plan = msm_plan(g, n, lanes, scalar_bits, window_bits)
    fused, c, B, npad, C, K, wg = plan.fused, plan.c, plan.B, plan.npad, plan.C, plan.K, plan.wg
    sc = scalars.movedim(1, 0)  # [Ls, lanes, n]
    if signed:
        digits_all, signs_all = (
            x.movedim(0, 1) for x in signed_window_digits(sc, c, scalar_bits)
        )  # each [lanes, W, n]
    else:
        digits_all = all_window_digits(sc, c, scalar_bits).movedim(0, 1)
        signs_all = torch.zeros_like(digits_all)

    if npad != n:
        digits_all = torch.nn.functional.pad(digits_all, (0, npad - n))
        signs_all = torch.nn.functional.pad(signs_all, (0, npad - n))
        inf = g.infinity((lanes, npad - n), device=dev)
        points = tuple(torch.cat([p, i], dim=-1) for p, i in zip(points, inf))

    # element-major AFFINE rows for the sorted gather; affine infinity
    # (incl. the padding) is encoded (0, 0), the mixed-add identity.  The
    # fused kernel reads Fq2 coordinates tower-major (x0 digits, then x1).
    def to_rows(coord):  # [*cs, lanes, npad] -> [lanes, npad, ce]
        if fused and D > 1:
            coord = coord.movedim(1, 0)
        return coord.reshape(ce, lanes, npad).movedim(0, -1)

    inf_mask = g.is_infinity(points)  # [lanes, npad]
    zero_xy = g.k.zero((lanes, npad), device=dev)
    x_aff = g.k.select(inf_mask, zero_xy, points[0])
    y_aff = g.k.select(inf_mask, zero_xy, points[1])
    em = torch.cat([to_rows(x_aff), to_rows(y_aff)], dim=-1)
    if signed and not fused:
        # second y-negated copy at element offset npad: a negative digit
        # gathers row (i + npad), so the sign costs an index add
        negy_aff = g.k.select(inf_mask, zero_xy, g.k.neg(points[1], k=1))
        em = torch.cat([em, torch.cat([to_rows(x_aff), to_rows(negy_aff)], dim=-1)], dim=1)

    w_padded = plan.n_groups * wg
    if w_padded != plan.num_windows:
        # zero-digit windows at the HIGH end: Horner adds infinity there
        pad = (0, 0, 0, w_padded - plan.num_windows)
        digits_all = torch.nn.functional.pad(digits_all, pad)
        signs_all = torch.nn.functional.pad(signs_all, pad)

    idx_bits = max(1, (npad - 1).bit_length())
    extra = 1 if signed else 0
    shift = extra + idx_bits
    iota_b = torch.arange(npad, device=dev, dtype=torch.int64).expand(lanes, wg, npad)
    l_iota = torch.arange(lanes, device=dev).reshape(lanes, 1, 1)
    w_iota = torch.arange(wg, device=dev).reshape(1, wg, 1)

    def sort_gidx(digits_g, signs_g):
        """-> (sorted_keys, order_t, sign_t): gather indices and sorted
        signs, pre-composed with the step-major storage transpose (sorted
        position j = c*K + k is stored at k*C + c)."""
        key = (digits_g.long() << shift) | iota_b
        if signed:
            key = key | (signs_g.long() << idx_bits)
        sorted_keys = torch.sort(key, dim=2).values
        gidx = sorted_keys & ((1 << idx_bits) - 1)
        sign = (sorted_keys >> idx_bits) & 1 if signed else torch.zeros_like(gidx)
        if signed and not fused:
            gidx = gidx + sign * npad

        def t_storage(a):
            return a.reshape(lanes, wg, C, K).transpose(-1, -2).reshape(lanes, wg, npad)

        return sorted_keys, t_storage(gidx), t_storage(sign)

    def cross_at(totals, jc) -> Point:
        """Suffix scan over the chunk totals (1/K of the data), exclusive,
        read at each target's chunk."""
        cross_incl = scan_points(g, totals, reverse=True, max_chunks=512)
        cross_excl = _roll(cross_incl, -1)
        cmask = torch.arange(C, device=dev) < C - 1
        cross_excl = g.select(cmask, cross_excl, g.infinity((lanes, wg, C), device=dev))
        return tuple(x[..., l_iota, w_iota, jc] for x in cross_excl)

    def tail(cap, cross, valid) -> Point:
        """gv = captured within-chunk values + cross-chunk suffix at the
        target's chunk; reduce the B-1 bucket-boundary values."""
        gv = g.add(cap, cross)  # batch (lanes, wg, B-1)
        gv = g.select(valid, gv, g.infinity((lanes, wg, B - 1), device=dev))
        m = B - 1
        tgt = 1 << (m - 1).bit_length()
        if tgt != m:
            gv = tuple(
                torch.cat([x, i], dim=-1)
                for x, i in zip(gv, g.infinity((lanes, wg, tgt - m), device=dev))
            )
        return reduce_points(g, gv)  # batch (lanes, wg)

    def boundaries(first_ge):
        valid = first_ge < npad
        j = torch.clamp(first_ge, max=npad - 1)
        return valid, j % K, j // K

    def uncat_rows(arr) -> Point:
        """[3*ce, *batch] tower-major rows -> Point."""
        out = []
        for i in range(3):
            cf = arr[i * ce : (i + 1) * ce]
            if D > 1:
                cf = cf.reshape((D, L) + tuple(cf.shape[1:])).movedim(0, 1)
            out.append(cf)
        return tuple(out)

    def group_sums_fused(digits_g, signs_g) -> Point:
        """Fused path: one suffix-scan launch over the group's gathered
        rows; the boundary values are rows of its prefix."""
        _, order_t, sign_t = sort_gidx(digits_g, signs_g)
        valid, jk, jc = boundaries(first_ge_histogram(digits_g, B))
        R = lanes * wg
        rows = em[l_iota, order_t].reshape(R, npad, 2 * ce)
        rows[..., 0] |= sign_t.reshape(R, npad).to(torch.int32) * SIGN_BIT
        if D == 1:
            prefix, totals = suffix_scan_g1_rows(g.k.spec, g.b3_val, rows, K, C)
        else:
            prefix, totals = suffix_scan_g2_rows(g.k.spec, g.k.nr_int, g.b3_val, rows, K, C)
        pos = (jk * C + jc).reshape(R, B - 1)
        cap_rows = prefix[torch.arange(R, device=dev)[:, None], pos]  # [R, B-1, 3*ce]
        cap = uncat_rows(cap_rows.movedim(-1, 0).reshape(3 * ce, lanes, wg, B - 1))
        totals = tuple(t.reshape(cs + (lanes, wg, C)) for t in totals)
        return tail(cap, cross_at(totals, jc), valid)

    def group_sums_capture(digits_g, signs_g) -> Point:
        """Capture path: K C-wide mixed adds, capturing the boundary
        values in flight."""
        sorted_keys, order_t, _ = sort_gidx(digits_g, signs_g)
        # sorted_keys = digit << shift (+ lower sign/index bits), so the
        # first key >= (v << shift) is the first digit >= v
        v_targets = (torch.arange(1, B, device=dev, dtype=torch.int64) << shift).expand(
            lanes * wg, B - 1
        ).contiguous()
        first_ge = torch.searchsorted(
            sorted_keys.reshape(lanes * wg, npad), v_targets, side="left"
        ).reshape(lanes, wg, B - 1)
        valid, jk, jc = boundaries(first_ge)
        rows = em[l_iota, order_t]  # [lanes, wg, npad, 2*ce]
        back = rows.movedim(-1, 0)  # [2*ce, lanes, wg, npad]
        xg = back[:ce].reshape(cs + (lanes, wg, npad))
        yg = back[ce:].reshape(cs + (lanes, wg, npad))
        cap, totals = scan_storage_mixed_capture(g, (xg, yg), K, C, jk, jc, reverse=True)
        return tail(cap, cross_at(totals, jc), valid)

    group_sums = group_sums_fused if fused else group_sums_capture
    sums = [
        group_sums(digits_all[:, gi * wg : (gi + 1) * wg], signs_all[:, gi * wg : (gi + 1) * wg])
        for gi in range(plan.n_groups)
    ]
    # window sums [*coords, lanes, W] (window 0 first), Horner from the top
    sums = tuple(torch.cat([s[i] for s in sums], dim=-1) for i in range(3))
    return g.horner(sums, c)
