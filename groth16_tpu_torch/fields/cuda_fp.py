"""CUDA kernel K1 — the Montgomery product — and its plain version.

Counterpart of `groth16_tpu/fields/pallas_fp.py:mont_mul_pallas`.  The
kernel (csrc/mont_mul.cu) runs one thread per element over
`uint32[L, N]` limb-major buffers: thread i reads column i of each limb
row, so a warp's loads are coalesced.  It folds both inputs and runs the
interleaved CIOS of `pallas_fp.cios` over 15-bit digits, so its output
is digit-identical to `mont_mul_plain`, the int64 transcription of
`fp._mont_mul_xla` kept here as its plain version.

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
# point-add libraries (one per L, curves/cuda_point.py) are built for them
KERNEL_LIMBS = (18, 26)
KP_ROWS = 35  # rows k*p, k = 0..34, of the constant table (csrc/field.cuh)


@functools.lru_cache(maxsize=None)
def kernel_consts(spec: FpSpec, b3_val, device: torch.device) -> torch.Tensor:
    """Constant table read by every kernel (layout: csrc/field.cuh):
    rows k*p for k = 0..34 (exact digits), then b3 in Montgomery form as
    two rows (c0, c1; G1 and K1 leave them zero), then one in Montgomery
    form (R mod p)."""
    L = spec.n_limbs
    rows = [int_to_limbs(k * spec.modulus, L) for k in range(KP_ROWS)]
    if b3_val is None:
        b3 = (0, 0)
    elif isinstance(b3_val, tuple):
        b3 = b3_val
    else:
        b3 = (b3_val, 0)
    rows += [int_to_limbs(spec.to_mont_int(v % spec.modulus), L) for v in b3 + (1,)]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1).to(device)


def _lib():
    from groth16_tpu_torch.utils.cuda_build import library

    lib = library("mont_mul")
    if not getattr(lib, "_g16_typed", False):
        P = ctypes.c_void_p
        lib.g16_mont_mul.argtypes = [
            ctypes.c_int, P, P, P, ctypes.c_longlong, P, ctypes.c_uint, P
        ]
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


def mont_mul(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p on [L, N] (either operand may be [L, 1]).
    Inputs any digit class with values < 8p; output exact digits < 2p."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    L = spec.n_limbs
    if L not in KERNEL_LIMBS:
        raise ValueError(f"mont_mul: no kernel for L = {L} (have {KERNEL_LIMBS})")
    n = max(a.shape[-1], b.shape[-1])
    a = check_operand(a, (L,), n, "a")
    b = check_operand(b, (L,), n, "b")
    out = torch.empty((L, n), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    consts = kernel_consts(spec, None, a.device)
    rc = _lib().g16_mont_mul(
        L, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, consts.data_ptr(),
        spec.n0inv, torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    LAUNCHES["mont_mul"] += 1
    return out


def mont_mul_plain(spec: FpSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the interleaved CIOS of fp._mont_mul_xla in
    int64.  a, b: [L, N] or [L, 1]; runs on any device.

    The uint32 original splits every partial product into its low and
    high 15 bits so that no column passes 2^23; int64 columns hold whole
    products (< 2^37 after L steps), so the split is dropped.  Each step
    still adds a_i * b, derives m from column i and adds m * p, and every
    column holds the same value mod 2^15 when m is derived, so the m's,
    the result (a b + M p) / R < 2p and its exact digits are the same."""
    from groth16_tpu_torch.fields.fp import fold, rex

    if a.is_cuda:
        PLAIN_CALLS["mont_mul"] += 1
    L = spec.n_limbs
    M = LIMB_MASK
    n = max(a.shape[-1], b.shape[-1])
    a = fold(a).to(torch.int64).expand(L, n)
    b = fold(b).to(torch.int64).expand(L, n)
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
