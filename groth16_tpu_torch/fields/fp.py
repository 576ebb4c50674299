"""Vectorized Montgomery field arithmetic on int32 limb tensors (PyTorch).

Port of `groth16_tpu/fields/fp.py`.  Element layout: `int32[L, *batch]`
of 15-bit little-endian digits in Montgomery form, R = 2^(15 L) —
limb-major: the limb axis LEADS and batch axes TRAIL.  The digit and
value classes are the JAX package's (fp.py there):

- digit class: exact (< 2^15), semi (<= 2^15 + 2^12, after one `fold`),
  lazy (< 2^27, sums of a few exact/semi values);
- value class: multiples of p bounding the value.  R >= 64 p; mont_mul
  takes values < 8p and returns < 2p; sub(a, b, k) returns a - b + k p.

Every digit class stays below 2^31, so digits live in `torch.int32`
(torch's uint32 lacks add/shift/compare on the CPU); the CUDA kernels
read the same buffers as uint32.  Everything here except `mont_mul` is
plain tensor code on any device; `mont_mul` dispatches by device to the
CUDA kernel K1 (fields/cuda_fp.py) or to its plain int64 version.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from groth16_tpu_torch.fields import cuda_fp
from groth16_tpu_torch.fields.spec import LIMB_BITS, LIMB_MASK, FpSpec, int_to_limbs

MASK = LIMB_MASK
I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _vec_cached(limbs: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(limbs, dtype=I32, device=device)


def _col(limbs: Sequence[int], device, ndim: int) -> torch.Tensor:
    """[W] digit column constant -> [W, 1, ...] aligned to rank `ndim`
    (cached per device, so hot loops do not re-upload constants)."""
    v = _vec_cached(tuple(int(x) for x in limbs), torch.device(device))
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


def const(spec: FpSpec, value: int, shape=(), mont: bool = True, device="cpu") -> torch.Tensor:
    """Broadcast a host integer constant to limb-tensor form (exact)."""
    v = value % spec.modulus
    if mont:
        v = spec.to_mont_int(v)
    col = _col(int_to_limbs(v, spec.n_limbs), device, 1 + len(tuple(shape)))
    return col.expand((spec.n_limbs,) + tuple(shape))


def zeros(spec: FpSpec, shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((spec.n_limbs,) + tuple(shape), dtype=I32, device=device)


def broadcast_shapes(*shapes) -> tuple:
    """Broadcast batch shapes (numpy's rule, which torch follows)."""
    return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))


def _align(a: torch.Tensor, b: torch.Tensor):
    """Insert missing batch axes (after the limb axis) so trailing-aligned
    broadcasting matches the limb-leading convention."""
    nd = max(a.dim(), b.dim())
    if a.dim() < nd:
        a = a.reshape(a.shape[:1] + (1,) * (nd - a.dim()) + a.shape[1:])
    if b.dim() < nd:
        b = b.reshape(b.shape[:1] + (1,) * (nd - b.dim()) + b.shape[1:])
    return a, b


# -- digit-class management ----------------------------------------------------


def fold(x: torch.Tensor) -> torch.Tensor:
    """lazy -> semi: one local carry fold (digits < 2^27 -> <= 2^15+2^12);
    the top digit's high part is dropped."""
    out = x & MASK
    out[1:] += x[:-1] >> LIMB_BITS
    return out


@functools.lru_cache(maxsize=None)
def _bit_iota(width: int, device: torch.device) -> torch.Tensor:
    return torch.arange(width, dtype=torch.int64, device=device)


def rex(cols: torch.Tensor, n_out: int, want_carry: bool = False):
    """Exact digit resolution: columns (< 2^30) -> digits < 2^15, value
    taken mod 2^(15 n_out).  With want_carry=True also returns the digit
    at n_out.

    Two folds bring every digit to <= 2^15; digit j then generates a carry
    (g_j: digit = 2^15) or propagates one (p_j: digit = 2^15 - 1).  The
    JAX package resolves the carries with a Kogge-Stone prefix; here the
    W <= 62 bits g and p of an element are packed into one int64 and one
    addition does it: bit j of ((g|p) + g) ^ (g|p) ^ g is the carry into
    digit j.  Both give the digits of the same value, so the same digits."""
    W = n_out + 1 if want_carry else n_out
    if W > 62:
        raise ValueError(f"rex: {W} digits do not pack into an int64")
    cur = cols.shape[0]
    if cur < W:
        x = torch.cat([cols, cols.new_zeros((W - cur,) + tuple(cols.shape[1:]))], dim=0)
    else:
        x = cols[:W]
    x = fold(fold(x))  # < 2^15 + 2^15, then <= 2^15
    iota = _bit_iota(W, x.device).reshape((W,) + (1,) * (x.dim() - 1))
    g = ((x >> LIMB_BITS).to(torch.int64) << iota).sum(0)
    gp = g | ((x == MASK).to(torch.int64) << iota).sum(0)
    carry_in = (((gp + g) ^ gp ^ g) >> iota) & 1
    digits = (x + carry_in.to(I32)) & MASK
    if want_carry:
        return digits[:n_out], digits[n_out]
    return digits


# -- lazy add / sub ------------------------------------------------------------


def add(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LAZY add: value(out) = value(a) + value(b); digits grow."""
    a, b = _align(a, b)
    return a + b


def sub(spec: FpSpec, a: torch.Tensor, b: torch.Tensor, k: int = 2) -> torch.Tensor:
    """a - b + k*p, EXACT output digits.  Requires value(b) < k*p; b may
    have any digit class (resolved here), a may be lazy."""
    L = spec.n_limbs
    a, b = _align(a, b)
    b_x = rex(b, L)
    off = _col(int_to_limbs(k * spec.modulus, L + 1)[:L], a.device, max(a.dim(), b_x.dim()))
    # a + (R-1 - b) + 1 + kp == a - b + k*p + R; resolving to L digits
    # drops the explicit +R.
    u = a + (MASK - b_x) + off
    u[0] += 1
    return rex(u, L)


def sub_exact(spec: FpSpec, a: torch.Tensor, b_exact: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Like sub but b must already have exact digits (< 2^15)."""
    L = spec.n_limbs
    a, b_exact = _align(a, b_exact)
    off = _col(int_to_limbs(k * spec.modulus, L + 1)[:L], a.device, max(a.dim(), b_exact.dim()))
    u = a + (MASK - b_exact) + off
    u[0] += 1
    return rex(u, L)


def neg(spec: FpSpec, a: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k*p - a (exact digits).  Requires value(a) < k*p."""
    return sub(spec, torch.zeros_like(a), a, k=k)


def cond_sub(spec: FpSpec, x: torch.Tensor, m_limbs: Sequence[int]) -> torch.Tensor:
    """x if x < m else x - m.  x: lazy ok, value < R; output exact."""
    L = spec.n_limbs
    x = rex(x, L)
    comp = _col([LIMB_MASK - v for v in m_limbs[:L]], x.device, x.dim())
    u = x + comp
    u[0] += 1
    digits, carry = rex(u, L, want_carry=True)
    return torch.where(carry > 0, digits, x)


def reduce_to_2p(spec: FpSpec, x: torch.Tensor, bound_k: int = 8) -> torch.Tensor:
    """value < bound_k * p -> [0, 2p), exact digits."""
    k = bound_k
    while k > 2:
        k = (k + 1) // 2
        x = cond_sub(spec, x, int_to_limbs(k * spec.modulus, spec.n_limbs))
    return x


def add_strict(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[0,2p) x [0,2p) -> [0,2p), exact digits."""
    return cond_sub(spec, add(spec, a, b), spec.two_p_limbs)


def sub_strict(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[0,2p) x [0,2p) -> a - b in [0,2p), exact digits."""
    return cond_sub(spec, sub(spec, a, b, k=2), spec.two_p_limbs)


# -- Montgomery multiplication ------------------------------------------------


def mont_mul(spec: FpSpec, a: torch.Tensor, b: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p.

    Inputs: any digit class, values < 8p.  Output: exact digits < 2p.
    Batch shapes broadcast; the product runs on the flattened batch as
    one call of K1 (CUDA tensor) or of its plain version (CPU tensor, or
    plain=True on any device).  An operand whose batch shape, leading
    ones dropped, is a suffix of the broadcast shape (a constant, or the
    NTT's twiddles [.., 1, h] against [.., blocks, h]) goes as [L, h] and
    is read with period h; only other broadcasts are materialised."""
    L = spec.n_limbs
    a, b = _align(a, b)
    batch = broadcast_shapes(a.shape[1:], b.shape[1:])
    n = math.prod(batch)

    def flat(x):
        own = tuple(x.shape[1:])
        while own and own[0] == 1:
            own = own[1:]
        if own == batch[len(batch) - len(own):]:
            return x.reshape(L, math.prod(own)).contiguous()
        return x.expand((L,) + tuple(batch)).reshape(L, n).contiguous()

    fn = cuda_fp.mont_mul_plain if plain else cuda_fp.mont_mul
    return fn(spec, flat(a), flat(b), n).reshape((L,) + tuple(batch))


def mul_const(spec: FpSpec, a: torch.Tensor, value: int) -> torch.Tensor:
    """Multiply by a host constant (encoded in Montgomery form)."""
    return mont_mul(spec, a, const(spec, value, (), device=a.device))


# -- normalization / comparisons ----------------------------------------------


def normalize(spec: FpSpec, a: torch.Tensor, bound_k: int = 8) -> torch.Tensor:
    """value < bound_k*p -> canonical [0, p), exact digits."""
    a = reduce_to_2p(spec, a, bound_k=bound_k)
    return cond_sub(spec, a, spec.p_limbs)


def is_zero(spec: FpSpec, a: torch.Tensor, bound_k: int = 8) -> torch.Tensor:
    n = normalize(spec, a, bound_k=bound_k)
    return torch.all(n == 0, dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask ? a : b; a batch-shaped mask broadcasts over trailing axes."""
    return torch.where(mask, a, b)


# -- Montgomery form conversion -------------------------------------------------


def to_mont(spec: FpSpec, a_std: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a_std, _col(spec.r2_limbs, a_std.device, a_std.dim()))


def from_mont(spec: FpSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> standard form (canonical [0, p))."""
    one = torch.zeros_like(a)
    one[0] = 1
    return normalize(spec, mont_mul(spec, a, one), bound_k=2)


# -- exponentiation and inversion -----------------------------------------------

# Sequential steps of the within-chunk pass of `_chunked_scan_mul`.  The JAX
# package caps the chunk count at 1024 (its scan body is one program either
# way); here every step is a K1 launch, so the chunk count grows with N and
# the step count stays fixed: at N = 2^22, 64 steps of 65,536-wide products
# and a 16-step cross pass.
SCAN_STEPS = 64


def pow_const(spec: FpSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-int exponent, square-and-multiply over the bits of e
    from the lowest: one K1 launch per square and one per set bit (the JAX
    package's scan selects the same products, so the digits are the same).
    Input value < 8p; output exact digits < 2p."""
    res = const(spec, 1, a.shape[1:], device=a.device)
    if e == 0:
        return res.contiguous()
    base = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            res = mont_mul(spec, res, base)
        if i + 1 < e.bit_length():
            base = mont_mul(spec, base, base)
    return res


def inv(spec: FpSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse (0 maps to 0).  Input value < 8p."""
    return pow_const(spec, fold(a), spec.modulus - 2)


def batch_inv(spec: FpSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion over all batch axes: one Fermat inverse
    and O(N) products from a prefix and a suffix product scan.  Zero
    entries map to zero.  a: [L, *batch], values < 8p; output < 2p."""
    L = spec.n_limbs
    shape = tuple(a.shape[1:])
    a = a.reshape(L, -1)
    n = a.shape[1]
    if n == 1:
        return inv(spec, a).reshape((L,) + shape)
    one = const(spec, 1, (n,), device=a.device)
    zmask = is_zero(spec, a)
    safe = select(zmask, one, a)
    prefix = _chunked_scan_mul(spec, safe, reverse=False)
    total_inv = inv(spec, prefix[:, -1:])
    suffix = _chunked_scan_mul(spec, safe, reverse=True)
    one_col = one[:, :1]
    suffix = torch.cat([suffix[:, 1:], one_col], dim=1)
    prefix_excl = torch.cat([one_col, prefix[:, :-1]], dim=1)
    out = mont_mul(spec, mont_mul(spec, prefix_excl, suffix), total_inv)
    return select(zmask, zeros(spec, (n,), device=a.device), out).reshape((L,) + shape)


def _chunked_scan_mul(spec: FpSpec, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive product scan over the element axis of x: [L, N].

    The JAX package's two-level decomposition: element j = c*K + k sits at
    [c, k] of a [C, K] view; K sequential C-wide products scan within the
    chunks, a Hillis-Steele pass over the C chunk totals gives each chunk
    the product of the chunks before it (after it, if reverse), and one
    N-wide product joins the two.  N is padded to C*K with ones, which
    leave every prefix and suffix product unchanged."""
    L, N = x.shape
    C = -(-N // SCAN_STEPS)
    K = -(-N // C)
    one = const(spec, 1, (1,), device=x.device)
    if C * K != N:
        x = torch.cat([x, one.expand(L, C * K - N)], dim=1)
    rows = x.reshape(L, C, K).permute(2, 0, 1).contiguous()  # [K, L, C]
    within = torch.empty_like(rows)
    acc = one.expand(L, C)
    for k in (reversed(range(K)) if reverse else range(K)):
        acc = mont_mul(spec, acc, rows[k])
        within[k] = acc
    pos = torch.arange(C, device=x.device)
    cross = acc  # chunk totals, then their inclusive scan
    s = 1
    while s < C:
        if reverse:
            shifted = select(pos + s < C, torch.roll(cross, -s, dims=1), one)
        else:
            shifted = select(pos >= s, torch.roll(cross, s, dims=1), one)
        cross = mont_mul(spec, cross, shifted)
        s <<= 1
    if reverse:
        cross_excl = select(pos < C - 1, torch.roll(cross, -1, dims=1), one)
    else:
        cross_excl = select(pos >= 1, torch.roll(cross, 1, dims=1), one)
    out = mont_mul(spec, within.permute(1, 2, 0), cross_excl[:, :, None])  # [L, C, K]
    return out.reshape(L, C * K)[:, :N]
