"""CUDA kernels K4-K7 — complete point additions — the MSM's Horner
chain, the proof assembly's scalar multiplication, and their plain
versions.

Counterpart of `groth16_tpu/curves/pallas_point.py`:

  add_g1        K4  replaces pallas_point.add_g1_pallas
  add_g2        K5  replaces pallas_point.add_g2_pallas
  add_mixed_g1  K6  replaces pallas_point.add_mixed_g1_pallas
  add_mixed_g2  K7  replaces pallas_point.add_mixed_g2_pallas
  horner_g1/g2  the Horner chain of `msm/pippenger.py` (a Python loop of
                K4/K5 launches before; the JAX package's `fori_loop` of
                `CurveDevice.add` at groth16_tpu/msm/pippenger.py:660)
  scalar_mul_g1/g2  per-lane double-and-add of the proof assembly (the
                JAX package's `fori_loop` of `CurveDevice.add` in
                `scalar_mul_bits`, groth16_tpu/curves/point.py:367)

One CUDA kernel body per formula (csrc/point_add.cu: rcb_add<F>,
rcb_add_mixed<F>, and K6's rcb_add_mixed_w) templated on the coordinate
field.  The full addition
(K4/K5), the G2 mixed addition (K7), the Horner chain and the scalar
multiplication run on a group
of lanes per point (6 for G1, 24 for G2), each of the formula's three
product stages one product a lane: most launches of a prove carry a few
points, where one addition's latency is the launch's time.  The G1 mixed
addition (K6), whose launches (the capture scan's steps) carry thousands
of points, runs one thread per point with its coordinates packed into
32-bit words (csrc/point.cuh: rcb_add_mixed_w), the word engine of K1,
at one of two occupancies (`mixed_g1_form`).
Coordinates are limb-major `int32[L, N]` (G1) or `int32[L, 2, N]` (G2),
< 2p with exact digits in and out.

Plain versions, beside each wrapper: K4/K5 run the stacked RCB path of
`groth16_tpu/curves/point.py:CurveDevice.add`; K6/K7 transcribe
`pallas_point.mixed_add_g1_math` and its Fp2 form; Horner is the loop of
`msm/pippenger.py` over the plain K4/K5, the scalar multiplication the
select loop of `CurveDevice.scalar_mul_bits`.  Their multiplies run the plain
version of K1, so they are plain PyTorch on any device.  The kernels
repeat the same operations in the same order and return the same
digits.

Each wrapper dispatches by device only: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from groth16_tpu_torch.fields.cuda_fp import (
    KERNEL_LIMBS,
    KERNEL_WORDS,
    check_operand,
    kernel_consts,
    word_consts,
)
from groth16_tpu_torch.fields.ops import Fp2Ops, FpOps
from groth16_tpu_torch.fields.spec import FpSpec

# launches per kernel, counted where the kernel is launched and nowhere
# else
LAUNCHES = {
    "add_g1": 0, "add_g2": 0, "horner_g1": 0, "horner_g2": 0, "add_mixed_g1": 0, "add_mixed_g2": 0,
    "scalar_mul_g1": 0, "scalar_mul_g2": 0,
}
# calls of the plain versions on CUDA tensors (the main path makes none)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
# the additions' launches by points a launch, and the most points of one
# launch
SIZE_CLASSES = ("1-4", "5-4096", ">4096")
LAUNCH_SIZES = {
    name: dict.fromkeys(SIZE_CLASSES, 0)
    for name in ("add_g1", "add_g2", "add_mixed_g1", "add_mixed_g2")
}
LARGEST_LAUNCH = dict.fromkeys(LAUNCH_SIZES, 0)


def size_class(n: int) -> str:
    return SIZE_CLASSES[0] if n <= 4 else SIZE_CLASSES[1] if n <= 4096 else SIZE_CLASSES[2]


# K6's forms (csrc/point_add.cu: g16_point_add_mixed_g1): one thread a
# point on 32-bit words with as many blocks an SM as its registers allow,
# or forced to more blocks an SM (fewer registers, some spilled)
MIXED_G1_FORMS = {"words": 0, "words_wide": 1}
WORD_THREADS = 128  # threads a block of K6 (csrc/point_add.cu: kWordThreads)


def mixed_g1_forms(L: int) -> tuple:
    """K6's forms built at L: both at L = 18 and 26, "words" alone at
    L = 52, where a forced third block a SM made no launch faster
    (csrc/point_add.cu: WordBlocks)."""
    return ("words",) if L == 52 else tuple(MIXED_G1_FORMS)


def mixed_g1_form(n: int, wave: dict) -> str:
    """K6's form for a launch of n points, where wave[form] is the points
    one wave of each form built holds on the card (`mixed_g1_waves`): the
    wide form where it runs the launch in fewer waves, else "words" (a
    wave of the wide form takes longer: PERF.md)."""
    if "words_wide" in wave and -(-n // wave["words_wide"]) < -(-n // wave["words"]):
        return "words_wide"
    return "words"


@functools.lru_cache(maxsize=None)
def mixed_g1_waves(L: int, device: torch.device) -> dict:
    """Points one wave of each K6 form built at L holds on `device`: its
    blocks an SM (the CUDA occupancy query) x SMs x WORD_THREADS."""
    lib = _lib(L, 1, True, 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = {}
    for form in mixed_g1_forms(L):
        code = MIXED_G1_FORMS[form]
        blocks = lib.g16_point_add_mixed_g1_blocks(code)
        if blocks <= 0:
            raise RuntimeError(f"add_mixed_g1: occupancy query of form {form} failed ({blocks})")
        wave[form] = blocks * sms * WORD_THREADS
    return wave


@functools.lru_cache(maxsize=None)
def mixed_word_consts(spec: FpSpec, b3_val: int):
    """K6's word constants: p and -p^-1 mod 2^32 (K1's), then 2p, 4p and
    b3 in Montgomery form, each as W words."""
    W = KERNEL_WORDS[spec.n_limbs]
    p = spec.modulus

    def words(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(W)]

    vals = list(word_consts(spec)) + words(2 * p) + words(4 * p) + words(spec.to_mont_int(b3_val % p))
    return (ctypes.c_uint * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def _plain_ops(spec: FpSpec, nr):
    return FpOps(spec, plain=True) if nr is None else Fp2Ops(spec, nr, plain=True)


def _lib(n_limbs: int, deg: int, mixed: bool, nr: int):
    from groth16_tpu_torch.utils.cuda_build import library, point_add_variant

    lib = library(point_add_variant(n_limbs, deg, mixed, nr))
    if not getattr(lib, "_g16_typed", False):
        P = ctypes.c_void_p
        tail = [ctypes.c_longlong, P, ctypes.c_uint, P]
        if mixed and deg == 1:
            lib.g16_point_add_mixed_g1.argtypes = (
                [ctypes.c_int] + [P] * 8 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint), P]
            )
            lib.g16_point_add_mixed_g1.restype = ctypes.c_int
            lib.g16_point_add_mixed_g1_blocks.argtypes = [ctypes.c_int]
            lib.g16_point_add_mixed_g1_blocks.restype = ctypes.c_int
        elif mixed:
            lib.g16_point_add_mixed_group.argtypes = [P] * 8 + tail
            lib.g16_point_add_mixed_group.restype = ctypes.c_int
        else:
            lib.g16_point_add_group.argtypes = [P] * 9 + tail
            lib.g16_point_add_group.restype = ctypes.c_int
            lib.g16_horner.argtypes = [P] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, P, ctypes.c_uint, P
            ]
            lib.g16_horner.restype = ctypes.c_int
            lib.g16_scalar_mul.argtypes = [P] * 7 + [
                ctypes.c_longlong, ctypes.c_int, P, ctypes.c_uint, P
            ]
            lib.g16_scalar_mul.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def _device(name, tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    return devs.pop()


def _check_kernel(name, spec, nr):
    """(L, D) of a kernel call; raises for a field no kernel is built for."""
    L = spec.n_limbs
    D = 1 if nr is None else 2
    if L not in KERNEL_LIMBS:
        raise ValueError(f"{name}: no kernel for L = {L} (have {KERNEL_LIMBS})")
    if D == 2 and not 1 <= abs(nr) <= 16:
        raise ValueError(f"{name}: no kernel for Fq2 nonresidue {nr}")
    return L, D


def _launch(name, mixed, spec, nr, b3_val, p1, p2):
    """Launch one point-add kernel on CUDA coordinates; nr is None for
    G1 (Fq coordinates), the Fq2 nonresidue for G2."""
    L, D = _check_kernel(name, spec, nr)
    lead = (L,) if D == 1 else (L, 2)
    n = max(x.shape[-1] for x in p1 + p2)
    ins = [check_operand(x, lead, n, f"{name} input {i}") for i, x in enumerate(p1 + p2)]
    dev = ins[0].device
    outs = [torch.empty(lead + (n,), dtype=torch.int32, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    lib = _lib(L, D, mixed, 0 if nr is None else nr)
    ptrs = [x.data_ptr() for x in ins] + [o.data_ptr() for o in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mixed and D == 1:  # K6
        form = MIXED_G1_FORMS[mixed_g1_form(n, mixed_g1_waves(L, dev))]
        rc = lib.g16_point_add_mixed_g1(form, *ptrs, n, mixed_word_consts(spec, b3_val), stream)
    else:  # K7, or K4/K5: a lane group a point
        fn = lib.g16_point_add_mixed_group if mixed else lib.g16_point_add_group
        rc = fn(*ptrs, n, kernel_consts(spec, b3_val, dev).data_ptr(), spec.n0inv, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    LAUNCH_SIZES[name][size_class(n)] += 1
    LARGEST_LAUNCH[name] = max(LARGEST_LAUNCH[name], n)
    return tuple(outs)


def _dispatch(name, mixed, spec, nr, b3_val, p1, p2):
    dev = _device(name, p1 + p2)
    if dev.type == "cpu":
        plain = mixed_add_plain if mixed else add_plain
        return plain(_plain_ops(spec, nr), b3_val, p1, p2)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return _launch(name, mixed, spec, nr, b3_val, p1, p2)


def add_g1(spec: FpSpec, b3_val: int, p1, p2):
    """K4: (X1,Y1,Z1) + (X2,Y2,Z2) on [L, N] coordinates."""
    return _dispatch("add_g1", False, spec, None, b3_val, p1, p2)


def add_g2(spec: FpSpec, nr: int, b3_val, p1, p2):
    """K5: K4 over Fq2 on [L, 2, N] coordinates."""
    return _dispatch("add_g2", False, spec, nr, b3_val, p1, p2)


def add_mixed_g1(spec: FpSpec, b3_val: int, p1, xy2):
    """K6: (X1,Y1,Z1) + affine (X2,Y2) on [L, N]; affine infinity is
    (0, 0) and passes P1 through."""
    return _dispatch("add_mixed_g1", True, spec, None, b3_val, p1, xy2)


def add_mixed_g2(spec: FpSpec, nr: int, b3_val, p1, xy2):
    """K7: K6 over Fq2 on [L, 2, N] coordinates."""
    return _dispatch("add_mixed_g2", True, spec, nr, b3_val, p1, xy2)


def _horner(name, spec, nr, b3_val, sums, c: int):
    dev = _device(name, sums)
    if dev.type == "cpu":
        return horner_plain(_plain_ops(spec, nr), b3_val, sums, c)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    L, D = _check_kernel(name, spec, nr)
    lead = (L,) if D == 1 else (L, 2)
    lanes, W = sums[0].shape[-2:]
    for i, x in enumerate(sums):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} input {i}: expected int32 digits, got {x.dtype}")
        if tuple(x.shape) != lead + (lanes, W) or not x.is_contiguous():
            raise ValueError(
                f"{name} input {i}: expected contiguous {lead + (lanes, W)}, got {tuple(x.shape)}"
            )
    if c < 1 or W < 1:
        raise ValueError(f"{name}: needs c >= 1 and a window, got c = {c}, {W} windows")
    outs = [torch.empty(lead + (lanes,), dtype=torch.int32, device=dev) for _ in range(3)]
    if lanes == 0:
        return tuple(outs)
    consts = kernel_consts(spec, b3_val, dev)
    rc = _lib(L, D, False, 0 if nr is None else nr).g16_horner(
        *[x.data_ptr() for x in sums], *[o.data_ptr() for o in outs], lanes, W, c,
        consts.data_ptr(), spec.n0inv, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return tuple(outs)


def horner_g1(spec: FpSpec, b3_val: int, sums, c: int):
    """sum_w 2^(c w) sums[.., w] for each lane: window sums (X, Y, Z) each
    [L, lanes, W] (window 0 first) -> points [L, lanes], in one launch."""
    return _horner("horner_g1", spec, None, b3_val, sums, c)


def horner_g2(spec: FpSpec, nr: int, b3_val, sums, c: int):
    """horner_g1 over Fq2: sums [L, 2, lanes, W] -> [L, 2, lanes]."""
    return _horner("horner_g2", spec, nr, b3_val, sums, c)


def _scalar_mul(name, spec, nr, b3_val, pt, bits):
    dev = _device(name, list(pt) + [bits])
    if dev.type == "cpu":
        return scalar_mul_plain(_plain_ops(spec, nr), b3_val, pt, bits)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    L, D = _check_kernel(name, spec, nr)
    lead = (L,) if D == 1 else (L, 2)
    if bits.dim() != 2:
        raise ValueError(f"{name}: expected bits [lanes, nbits], got {tuple(bits.shape)}")
    lanes, nbits = bits.shape
    ins = [check_operand(x, lead, lanes, f"{name} input {i}") for i, x in enumerate(pt)]
    if bits.dtype != torch.int32 or not bits.is_contiguous():
        raise TypeError(f"{name}: expected contiguous int32 bits, got {bits.dtype}")
    if nbits < 1:
        raise ValueError(f"{name}: needs at least one bit")
    outs = [torch.empty(lead + (lanes,), dtype=torch.int32, device=dev) for _ in range(3)]
    if lanes == 0:
        return tuple(outs)
    consts = kernel_consts(spec, b3_val, dev)
    rc = _lib(L, D, False, 0 if nr is None else nr).g16_scalar_mul(
        *[x.data_ptr() for x in ins], bits.data_ptr(), *[o.data_ptr() for o in outs], lanes, nbits,
        consts.data_ptr(), spec.n0inv, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    return tuple(outs)


def scalar_mul_g1(spec: FpSpec, b3_val: int, pt, bits):
    """bits[l] * P[l] for each lane: points (X, Y, Z) each [L, lanes],
    bits int32 [lanes, nbits] little-endian -> [L, lanes], in one launch."""
    return _scalar_mul("scalar_mul_g1", spec, None, b3_val, pt, bits)


def scalar_mul_g2(spec: FpSpec, nr: int, b3_val, pt, bits):
    """scalar_mul_g1 over Fq2: points [L, 2, lanes] -> [L, 2, lanes]."""
    return _scalar_mul("scalar_mul_g2", spec, nr, b3_val, pt, bits)


# -- plain versions --------------------------------------------------------------


def _count_plain(k, mixed, x):
    if x.is_cuda:
        base = "add_mixed_g" if mixed else "add_g"
        PLAIN_CALLS[base + str(k.tower_deg)] += 1


def add_plain(k, b3_val, p1, p2):
    """Plain version of K4/K5: the stacked RCB complete addition of
    `groth16_tpu/curves/point.py:CurveDevice.add` (a = 0).

    Value ledger (multiples of p): pre-adds < 4p; M1 products <= 16p^2;
    t3/t4/t5 < 6p; t0t < 6p; M2 <= 6p^2; Z3s/t1m < 4p; M3 products
    <= 36p^2; X3/Y3/Z3 pre-reduce < 4p."""
    _count_plain(k, False, p1[0])
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    b3 = k.const(b3_val, device=X1.device)
    t0, t1, t2, m3, m4, m5 = k.mul_many(
        [
            (X1, X2),
            (Y1, Y2),
            (Z1, Z2),
            (X1 + Y1, X2 + Y2),
            (Y1 + Z1, Y2 + Z2),
            (X1 + Z1, X2 + Z2),
        ]
    )
    t3, t4, t5 = k.sub_many(
        [(m3, t0 + t1), (m4, t1 + t2), (m5, t0 + t2)], k=4
    )  # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1; each < 6p
    t0t = t0 + t0 + t0  # 3*X1X2 < 6p lazy
    t2b, t5b = k.mul_many([(t2, b3), (t5, b3)])
    Z3s = t1 + t2b  # < 4p lazy
    t1m = k.sub_exact(t1, t2b, k=2)  # < 4p exact
    w0, w1, w2, w3, w4, w5 = k.mul_many(
        [(t4, t5b), (t3, t1m), (t5b, t0t), (t1m, Z3s), (t0t, t3), (Z3s, t4)]
    )
    X3 = k.sub_exact(w1, w0, k=2)  # < 4p
    Y3 = w3 + w2  # < 4p lazy
    Z3 = w5 + w4  # < 4p lazy
    return tuple(k.reduce2p_many([X3, Y3, Z3], bound_k=4))


def horner_plain(k, b3_val, sums, c: int):
    """Plain version of the Horner kernel: the loop of msm/pippenger.py
    over the plain K4/K5, from res = (0 : 1 : 0): for each window from the
    top, c doublings add(res, res), then add(res, sums[.., w])."""
    X = sums[0]
    if X.is_cuda:
        PLAIN_CALLS[f"horner_g{k.tower_deg}"] += 1
    lanes, W = X.shape[-2:]
    res = (
        k.zero((lanes,), device=X.device),
        k.one((lanes,), device=X.device).contiguous(),
        k.zero((lanes,), device=X.device),
    )
    for w in reversed(range(W)):
        for _ in range(c):
            res = add_plain(k, b3_val, res, res)
        res = add_plain(k, b3_val, res, tuple(x[..., w] for x in sums))
    return res


def scalar_mul_plain(k, b3_val, pt, bits):
    """Plain version of the scalar-multiplication kernel: the select loop
    of `groth16_tpu/curves/point.py:CurveDevice.scalar_mul_bits` over the
    plain K4/K5, from acc = (0 : 1 : 0): for each bit i, acc = add(acc,
    base) where bits[.., i] is set, then base = add(base, base)."""
    if bits.is_cuda:
        PLAIN_CALLS[f"scalar_mul_g{k.tower_deg}"] += 1
    X = pt[0]
    lanes = X.shape[-1]
    acc = (
        k.zero((lanes,), device=X.device),
        k.one((lanes,), device=X.device).contiguous(),
        k.zero((lanes,), device=X.device),
    )
    base = pt
    for i in range(bits.shape[-1]):
        take = (bits[..., i] & 1).bool()
        acc = tuple(torch.where(take, s, a) for s, a in zip(add_plain(k, b3_val, acc, base), acc))
        base = add_plain(k, b3_val, base, base)
    return acc


def mixed_add_plain(k, b3_val, p1, xy2):
    """Plain version of K6/K7: `pallas_point.mixed_add_g1_math` (and its
    Fp2 form) — Z2 = 1, so t2 = Z1, t4 = Y1 + Y2*Z1, t5 = X1 + X2*Z1
    (< 4p lazy), 13 products.  Lanes whose Y2 digits are all zero
    (affine infinity) return P1 unchanged."""
    _count_plain(k, True, p1[0])
    X1, Y1, Z1 = p1
    X2, Y2 = xy2
    b3 = k.const(b3_val, device=X1.device)
    inf2 = torch.all((Y2 == 0).flatten(0, k.coord_ndim - 1), dim=0)
    t0, t1, m3, y2z1, x2z1, t2b = k.mul_many(
        [(X1, X2), (Y1, Y2), (X1 + Y1, X2 + Y2), (Y2, Z1), (X2, Z1), (Z1, b3)]
    )
    t3 = k.sub(m3, t0 + t1, k=4)  # X1Y2+X2Y1 < 6p
    t4 = Y1 + y2z1  # < 4p lazy
    t5 = X1 + x2z1  # < 4p lazy
    t0t = t0 + t0 + t0  # 3*X1X2 < 6p lazy
    (t5b,) = k.mul_many([(t5, b3)])
    Z3s = t1 + t2b  # < 4p lazy
    t1m = k.sub(t1, t2b, k=2)  # < 4p exact
    w0, w1, w2, w3, w4, w5 = k.mul_many(
        [(t4, t5b), (t3, t1m), (t5b, t0t), (t1m, Z3s), (t0t, t3), (Z3s, t4)]
    )
    X3 = k.sub(w1, w0, k=2)  # < 4p
    Y3 = w3 + w2  # < 4p lazy
    Z3 = w5 + w4  # < 4p lazy
    X3, Y3, Z3 = k.reduce2p_many([X3, Y3, Z3], bound_k=4)
    return (
        torch.where(inf2, X1, X3),
        torch.where(inf2, Y1, Y3),
        torch.where(inf2, Z1, Z3),
    )
