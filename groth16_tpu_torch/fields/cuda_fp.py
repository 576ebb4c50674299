"""CUDA kernel K1 — the Montgomery product — and its plain version.

Counterpart of `groth16_tpu/fields/pallas_fp.py:mont_mul_pallas`.  The
kernel (csrc/mont_mul.cu) runs over `uint32[L, N]` limb-major buffers,
one or two neighbouring elements a thread (`elements_per_thread`), so a
warp's loads are coalesced.  It resolves both inputs to exact digits, packs them into
32-bit words and runs the Montgomery product with R = 2^(15 L) on the
words (csrc/field.cuh: mont_mul_words): the same T = (a b + M p) / R as
the 15-bit CIOS of `pallas_fp.cios`, so its output is digit-identical to
`mont_mul_plain`, the int64 transcription of `fp._mont_mul_xla` kept
here as its plain version.  Either operand may be `[L, h]` with h | n,
read in place with period h (element i reads column i mod h): constants
and the NTT's per-stage twiddles reach the kernel without a copy.

`mont_mul` dispatches by device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from groth16_tpu_torch.fields.spec import LIMB_BITS, LIMB_MASK, FpSpec, int_to_limbs

# launches of K1, counted where the kernel is launched and nowhere else
LAUNCHES = {"mont_mul": 0}
# calls of the plain version on a CUDA tensor (the main path makes none)
PLAIN_CALLS = {"mont_mul": 0}

# digit counts with a kernel: csrc/mont_mul.cu instantiates these, and the
# point-add libraries (one per L, curves/cuda_point.py) are built for them:
# 18 (bn254), 21 (MNT4-298's and MNT6-298's Fq and Fr), 26 (BLS12's Fq,
# BW6-761's Fr) and 52 (BW6-761's Fq)
KERNEL_LIMBS = (18, 21, 26, 52)
KP_ROWS = 35  # rows k*p, k = 0..34, of the constant table (csrc/field.cuh)


def _tower(v) -> tuple:
    """An int or an Fq2 tuple -> its two components (0 appended)."""
    v = (v,) if not isinstance(v, tuple) else v
    return tuple(v) + (0,) * (2 - len(v))


@functools.lru_cache(maxsize=None)
def kernel_consts(spec: FpSpec, b3_val, device: torch.device) -> torch.Tensor:
    """Constant table read by the 15-bit kernels (layout: csrc/field.cuh):
    rows k*p for k = 0..34 (exact digits), then, in Montgomery form, b3's
    components c0, c1 (zero for G1) and one (R mod p)."""
    L = spec.n_limbs
    rows = [int_to_limbs(k * spec.modulus, L) for k in range(KP_ROWS)]
    rows += [int_to_limbs(spec.to_mont_int(v % spec.modulus), L) for v in _tower(b3_val) + (1,)]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1).to(device)


# 32-bit words an operand below 8p takes at each L with a kernel
# (csrc/field.cuh: Words<L>::W)
KERNEL_WORDS = {18: 9, 21: 10, 26: 12, 52: 24}
# K1's launches by elements a launch, those that read an operand with a
# period h < n, and those at each L ("L21": MNT's Fq and Fr, "L52":
# BW6-761's Fq)
SIZE_CLASSES = ("1-4096", "4097-65536", ">65536")
LAUNCH_SIZES = {
    "mont_mul": dict.fromkeys(SIZE_CLASSES + ("period",) + tuple(f"L{L}" for L in KERNEL_LIMBS), 0)
}
LARGEST_LAUNCH = {"mont_mul": 0}


def size_class(n: int) -> str:
    return SIZE_CLASSES[0] if n <= 4096 else SIZE_CLASSES[1] if n <= 65536 else SIZE_CLASSES[2]


# elements a thread K1 is built for at each L (csrc/mont_mul.cu)
KERNEL_VECTORS = {18: (1, 2), 21: (1, 2), 26: (1, 2), 52: (1,)}


def elements_per_thread(L: int, n: int) -> int:
    """Elements a thread of a K1 launch of n elements; the wrapper takes
    one where n or an operand's alignment does not allow two.  From
    chip_smoke.py's sweep (PERF.md): one keeps the most warps in flight
    where n is small; at L = 18 two (64-bit loads) are a few per cent
    faster from 2^18 elements on.  L = 52 has a kernel for one only."""
    return 2 if L == 18 and n >= 1 << 18 else 1


@functools.lru_cache(maxsize=None)
def word_consts(spec: FpSpec):
    """K1's launch constants: p as W words, then -p^-1 mod 2^32."""
    W = KERNEL_WORDS[spec.n_limbs]
    p = spec.modulus
    if 8 * p > 1 << (32 * W):
        raise ValueError(f"mont_mul: 8p does not fit in {W} words for L = {spec.n_limbs}")
    words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(W)] + [(-pow(p, -1, 1 << 32)) % (1 << 32)]
    return (ctypes.c_uint * len(words))(*words)


def _lib():
    from groth16_tpu_torch.utils.cuda_build import library

    lib = library("mont_mul")
    if not getattr(lib, "_g16_typed", False):
        P, U = ctypes.c_void_p, ctypes.c_uint
        lib.g16_mont_mul.argtypes = [ctypes.c_int, P, U, P, U, P, U, ctypes.POINTER(U), ctypes.c_int, P]
        lib.g16_mont_mul.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def check_operand(x: torch.Tensor, lead: tuple, n: int, name: str) -> torch.Tensor:
    """Wrapper input check: int32, shape lead + (n,) or lead + (1,)
    (broadcast, expanded here), contiguous.  Raises on anything else."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 digits, got {x.dtype}")
    if tuple(x.shape[:-1]) != lead or x.shape[-1] not in (1, n):
        raise ValueError(f"{name}: expected shape {lead + (n,)}, got {tuple(x.shape)}")
    if x.shape[-1] != n:
        return x.expand(lead + (n,)).contiguous()
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
    return x


def _check_period(x: torch.Tensor, L: int, n: int, name: str) -> int:
    """K1's operand check: int32 [L, h] with h | n, contiguous; -> h."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 digits, got {x.dtype}")
    h = x.shape[-1] if x.dim() == 2 else -1
    if x.shape[0] != L or h < 0 or (h == 0) != (n == 0) or (h and n % h):
        raise ValueError(f"{name}: expected [{L}, h] with h dividing {n}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
    return h


def mont_mul(spec: FpSpec, a: torch.Tensor, b: torch.Tensor, n: int = None) -> torch.Tensor:
    """a*b*R^-1 mod p on n elements: each operand [L, n], or [L, h] with
    h | n read with period h (n defaults to the wider operand).  Inputs
    any digit class with values < 8p; output [L, n], exact digits < 2p."""
    if n is None:
        n = max(a.shape[-1], b.shape[-1])
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b, n)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    L = spec.n_limbs
    if L not in KERNEL_LIMBS:
        raise ValueError(f"mont_mul: no kernel for L = {L} (have {KERNEL_LIMBS})")
    if n >= 1 << 31:
        raise ValueError(f"mont_mul: {n} elements, the kernel takes fewer than 2^31")
    ha, hb = _check_period(a, L, n, "a"), _check_period(b, L, n, "b")
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    vec = elements_per_thread(L, n)
    # two elements must divide n and sit 8-byte aligned in each operand
    # they are loaded from together (one whose period is odd is read a
    # column at a time)
    if vec == 2 and (n % 2 or any(h % 2 == 0 and x.data_ptr() % 8 for x, h in ((a, ha), (b, hb)))):
        vec = 1
    rc = _lib().g16_mont_mul(
        L, a.data_ptr(), ha, b.data_ptr(), hb, out.data_ptr(), n, word_consts(spec), vec,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    LAUNCHES["mont_mul"] += 1
    sizes = LAUNCH_SIZES["mont_mul"]
    sizes[size_class(n)] += 1
    sizes["period"] += min(ha, hb) < n
    sizes[f"L{L}"] += 1
    LARGEST_LAUNCH["mont_mul"] = max(LARGEST_LAUNCH["mont_mul"], n)
    return out


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """[L, h] with h | n -> [L, n], column i = column i mod h."""
    h = x.shape[-1]
    return x if h == n else x.expand(x.shape[0], n) if h == 1 else x.repeat(1, n // h)


# CPU products of at most this many elements run on Python ints
# (_mont_mul_ints): the int64 CIOS's ~5 L tensor operations a call cost
# milliseconds whatever n is, the ints microseconds an element
PLAIN_INT_MAX_N = 64


def mont_mul_plain(spec: FpSpec, a: torch.Tensor, b: torch.Tensor, n: int = None) -> torch.Tensor:
    """Plain version of K1: the interleaved CIOS of fp._mont_mul_xla in
    int64.  a, b: [L, n], or [L, h] with h | n read with period h (as
    `mont_mul`); runs on any device.

    The uint32 original splits every partial product into its low and
    high 15 bits so that no column passes 2^23; int64 columns hold whole
    products (< 2^37 after L steps), so the split is dropped.  Each step
    still adds a_i * b, derives m from column i and adds m * p, and every
    column holds the same value mod 2^15 when m is derived, so the m's,
    the result (a b + M p) / R < 2p and its exact digits are the same.
    On the CPU, up to PLAIN_INT_MAX_N elements go through _mont_mul_ints,
    which gives the same digits."""
    from groth16_tpu_torch.fields.fp import fold, rex

    if a.is_cuda:
        PLAIN_CALLS["mont_mul"] += 1
    L = spec.n_limbs
    M = LIMB_MASK
    if n is None:
        n = max(a.shape[-1], b.shape[-1])
    a = _tile(fold(a).to(torch.int64), n)
    b = _tile(fold(b).to(torch.int64), n)
    if a.device.type == "cpu" and n <= PLAIN_INT_MAX_N:
        return _mont_mul_ints(spec, a, b)
    p_vec = torch.tensor(spec.p_limbs, dtype=torch.int64, device=a.device)[:, None].expand(L, n)
    n0 = int(spec.n0inv)
    # acc[i : i + L + 1] is the (L+1)-column accumulator of step i: the
    # shift by one column at the end of each step is a moving window
    acc = torch.zeros((2 * L + 1, n), dtype=torch.int64, device=a.device)
    for i in range(L):
        cols = acc[i : i + L]
        cols.addcmul_(b, a[i : i + 1])  # semi*semi < 2^31
        m = (acc[i] * n0) & M  # the low 15 bits decide; acc[i] * n0 < 2^53
        cols.addcmul_(p_vec, m[None])
        acc[i + 1] += acc[i] >> LIMB_BITS  # acc[i] = 0 mod 2^15 now
    # value < 2p < R: the top column is zero; one fold brings the columns
    # below 2^30, then resolve to exact digits
    return rex(fold(acc[L:]).to(torch.int32), L)


@functools.lru_cache(maxsize=None)
def _neg_p_inv(p: int, n_limbs: int) -> int:
    """-p^-1 mod R = 2^(15 L)."""
    R = 1 << (LIMB_BITS * n_limbs)
    return -pow(p, -1, R) % R


def _mont_mul_ints(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mont_mul_plain's digits on Python ints, for folded int64 [L, n]
    operands on the CPU.  The CIOS's M = sum m_i 2^(15 i) has every m_i
    in [0, 2^15) and makes a b + M p = 0 mod R, so it is the one M in
    [0, R) that does: (-a b p^-1) mod R.  The result (a b + M p) / R is
    returned mod R in exact digits, as rex does."""
    L, p = spec.n_limbs, spec.modulus
    bits, R = LIMB_BITS * L, 1 << (LIMB_BITS * L)
    shifts = range(0, bits, LIMB_BITS)
    neg_pinv = _neg_p_inv(p, L)
    out = []
    for col_a, col_b in zip(a.T.tolist(), b.T.tolist()):
        t = sum(d << s for d, s in zip(col_a, shifts)) * sum(d << s for d, s in zip(col_b, shifts))
        v = (t + (t * neg_pinv & (R - 1)) * p) >> bits & (R - 1)
        out.append([v >> s & LIMB_MASK for s in shifts])
    return torch.tensor(out, dtype=torch.int32).reshape(-1, L).T.contiguous()
