"""Op-rate microbenchmark of the card (kernel V) and its plain version.

Counterpart of `scripts/ubench_vpu.py`: what is the speed of light for the
operations the Montgomery product is made of?  Each of seven operations
runs R steps of four cross-coupled chains per element (csrc/ubench_ops.cu,
one kernel per operation) over N elements; the rate is R*N operations over
the kernel's time.  The measured 32-bit multiply rate is the denominator of
the operations bounds that chip_smoke.py prints.

    python -m groth16_tpu_torch.utils.ubench       # on a machine with the card

prints one line per operation, as the TPU script does.  `chains` dispatches
by device: CPU tensors run `chains_plain`, CUDA tensors launch the kernel or
raise.  The plain version repeats the chains in PyTorch: u32 operations in
int64 masked to 32 bits after every step (torch has no u32 arithmetic),
i32 in the same bits read as two's complement, f32 natively.  Integer
results equal the kernel's word for word; f32 ones agree within F32_RTOL,
since the card's FMA rounds once where x*y + y in PyTorch rounds twice.
"""

from __future__ import annotations

import ctypes
import statistics
import sys
from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2^32 for int64 tensors holding values in [0, 2^32),
    without int64 overflow: split x into 16-bit halves."""
    lo = (x & 0xFFFF) * y
    hi = (((x >> 16) * y) & 0xFFFF) << 16
    return (lo + hi) & M32


class Op(NamedTuple):
    key: str
    label: str  # the TPU script's line label (ubench_vpu.py:92-102)
    kind: str  # "u32", "i32" or "f32"
    plain: object  # the chain step on the plain version's representation


OPS = (
    Op("u32_mul", "u32 mul", "u32", _mul32),
    Op("u32_add", "u32 add", "u32", lambda x, y: (x + y) & M32),
    Op(
        "u32_cios", "u32 mul+mask+shift+2add (CIOS inner)", "u32",
        lambda x, y: (((p := _mul32(x, y)) & 0x7FFF) + (p >> 15) + y) & M32,
    ),
    Op("u16_mul", "u16 mul (u32 lanes, 15-bit vals)", "u32", lambda x, y: (x & 0xFFFF) * (y & 0xFFFF)),
    Op("f32_mul", "f32 mul", "f32", lambda x, y: x * y),
    Op("f32_fma", "f32 fma", "f32", lambda x, y: x * y + y),
    Op("i32_mul", "i32 mul", "i32", _mul32),
)
OP_INDEX = {op.key: i for i, op in enumerate(OPS)}
# relative tolerance of the f32 chains against their plain version
F32_RTOL = 1e-4

# launches of V, counted where the kernel is launched and nowhere else
LAUNCHES = {op.key: 0 for op in OPS}
# calls of the plain version on a CUDA tensor
PLAIN_CALLS = {op.key: 0 for op in OPS}


def _lib():
    from groth16_tpu_torch.utils.cuda_build import library

    lib = library("ubench_ops")
    if not getattr(lib, "_g16_typed", False):
        P = ctypes.c_void_p
        lib.g16_ubench.argtypes = [ctypes.c_int, P, P, P, ctypes.c_longlong, ctypes.c_int, P]
        lib.g16_ubench.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def _dtype(op: Op) -> torch.dtype:
    return torch.float32 if op.kind == "f32" else torch.int32


def inputs(key: str, n: int, seed: int, device="cpu"):
    """(a, b) as the TPU script draws them: integers in [0, 2^15) for the
    integer operations (its int32 case casts uniform floats, i.e. zeros; here
    integers like the u32 case), uniform [0, 1) for f32."""
    op = OPS[OP_INDEX[key]]
    rng = np.random.default_rng(seed)
    if op.kind == "f32":
        a, b = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    else:
        a, b = (rng.integers(0, 1 << 15, n).astype(np.int32) for _ in range(2))
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def _check(op: Op, a: torch.Tensor, b: torch.Tensor, R: int):
    if R % 16 or R <= 0:
        raise ValueError(f"R = {R}: must be a positive multiple of 16")
    if a.dtype != _dtype(op) or b.dtype != _dtype(op):
        raise TypeError(f"{op.key}: expected {_dtype(op)} inputs, got {a.dtype}, {b.dtype}")
    if a.shape != b.shape or a.dim() != 1 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{op.key}: expected two contiguous 1-D tensors of one length")


def chains(key: str, a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    """R steps of the four chains of operation `key` per element of a, b
    (1-D; int32 holding the u32/i32 bits, or float32).  Returns the
    combined chains in the input dtype."""
    op = OPS[OP_INDEX[key]]
    _check(op, a, b, R)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return chains_plain(key, a, b, R)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"{key}: operands on {a.device} and {b.device}")
    out = torch.empty_like(a)
    rc = _lib().g16_ubench(
        OP_INDEX[key], a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), R // 16,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ubench {key} kernel launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return out


def chains_plain(key: str, a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    """Plain version of V: the same chains in PyTorch ops, on any device."""
    op = OPS[OP_INDEX[key]]
    _check(op, a, b, R)
    if a.is_cuda:
        PLAIN_CALLS[key] += 1
    if op.kind == "f32":
        x0, x1, x2, x3 = a, a + 1, a + 2, b
    else:
        a64, b64 = a.to(torch.int64) & M32, b.to(torch.int64) & M32
        x0, x1, x2, x3 = a64, (a64 + 1) & M32, (a64 + 2) & M32, b64
    f = op.plain
    for _ in range(R // 4):
        x0 = f(x0, x1)
        x1 = f(x1, x2)
        x2 = f(x2, x3)
        x3 = f(x3, x0)
    if op.kind == "f32":
        return ((x0 + x1) + x2) + x3
    v = x0 ^ x1 ^ x2 ^ x3 if op.kind == "u32" else (x0 + x1 + x2 + x3) & M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def agree(key: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of the kernel's and the plain version's output
    (0 required for the integer ops); raises where they disagree beyond
    the stated tolerance."""
    op = OPS[OP_INDEX[key]]
    if op.kind != "f32":
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"ubench {key}: kernel and plain version differ")
        return float(err)
    if not torch.allclose(got, want, rtol=F32_RTOL, atol=0.0, equal_nan=True):
        raise AssertionError(f"ubench {key}: kernel and plain version differ beyond rtol {F32_RTOL}")
    finite = torch.isfinite(got) & torch.isfinite(want)
    return float((got - want)[finite].abs().max()) if bool(finite.any()) else 0.0


def time_ms(fn, reps: int = 10) -> float:
    """Median of `reps` CUDA-event times of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bench(key: str, n: int = 1 << 20, R: int = 2048, reps: int = 10, device="cuda") -> dict:
    """Time operation `key` on the card at N = n, R steps: the median of
    `reps` launches after a warm-up, and its rate in operations per second
    (R * n operations, the TPU script's count)."""
    a, b = inputs(key, n, seed=OP_INDEX[key], device=device)
    ms = time_ms(lambda: chains(key, a, b, R), reps)
    return {"op": key, "label": OPS[OP_INDEX[key]].label, "n": n, "R": R, "ms": ms,
            "ops_per_s": R * n / (ms * 1e-3)}


def mul_rate(n: int = 1 << 20, R: int = 2048, device="cuda") -> float:
    """The card's measured 32-bit multiply rate (operations per second):
    the larger of the u32 and i32 multiply rates at R and at 8R steps (at R
    the launch, the ramp and the last wave of blocks take part of a short
    kernel).  The denominator of the operations bounds and of the bench's
    speed-of-light fractions."""
    return max(bench(k, n, r, device=device)["ops_per_s"] for k in ("u32_mul", "i32_mul") for r in (R, 8 * R))


def main() -> int:
    if not torch.cuda.is_available():
        print("ubench: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    n, R = 1 << 20, 2048
    for op in OPS:
        row = bench(op.key, n, R)
        rate = row["ops_per_s"] / 1e9
        print(f"{op.label:40s}: {rate:8.1f} G op/s  ({row['ms']:.2f} ms for {R}x{n})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
