"""CUDA kernels K4-K7 — complete point additions — the MSM's Horner
chain, the proof assembly's scalar multiplication, and their plain
versions.

Counterpart of `groth16_tpu/curves/pallas_point.py`:

  add_g1        K4  replaces pallas_point.add_g1_pallas
  add_g2        K5  replaces pallas_point.add_g2_pallas
  add_mixed_g1  K6  replaces pallas_point.add_mixed_g1_pallas
  add_mixed_g2  K7  replaces pallas_point.add_mixed_g2_pallas
  horner_g1/g2  the Horner chain of `msm/pippenger.py` (the JAX package's
                `fori_loop` of `CurveDevice.add` at
                groth16_tpu/msm/pippenger.py:660): csrc/horner.cu, one
                block an MSM lane, the doubling and addition programs of
                curves/formulas.py on 32-bit words
  scalar_mul_g1/g2  the proof assembly's per-lane scalar multiplication
                (the JAX package's `fori_loop` of `CurveDevice.add` in
                `scalar_mul_bits`, groth16_tpu/curves/point.py:367):
                csrc/horner.cu, one block a lane, fixed windows of
                SCALAR_MUL_WINDOW bits on Horner's programs
  capture_step_g1/g2  one step of the capture scan where a != 0: the
                accumulator plus an affine row, and the step before's
                captures, in one launch (the JAX package's from_affine,
                `_add_general` and select, groth16_tpu/msm/scans.py)

The full addition, Horner and the scalar multiplication also take the
curve coefficient a: where a != 0 (MNT4-298, MNT6-298) the full addition
and the capture step run the generic-a group kernel (csrc/general_add.cu:
RCB algorithm 1, the JAX package's `CurveDevice._add_general`,
groth16_tpu/curves/point.py:200, which has no Pallas kernel; 32-bit
words, one lane a tower component) over Fq, Fq2 (MNT4's nonresidue 17)
or Fq3 (MNT6's G2, `deg` 3), Horner and the scalar multiplication its
programs for that law.  The mixed additions and the scans exist for a =
0 only, as in the JAX package.

One CUDA kernel body per formula (csrc/point_add.cu: rcb_add<F>,
rcb_add_mixed<F>, and K6's rcb_add_mixed_w) templated on the coordinate
field.  The full addition
(K4/K5) and the G2 mixed addition (K7) run on a group of lanes per point
(6 for G1, 24 for G2 over Fq2), each of the formula's three product
stages one product a lane: most launches of a prove carry a few points,
where one addition's latency is the launch's time.  The G1 mixed
addition (K6), whose launches (the capture scan's steps) carry thousands
of points, runs one thread per point with its coordinates packed into
32-bit words (csrc/point.cuh: rcb_add_mixed_w), the word engine of K1,
at one of two occupancies (`mixed_g1_form`).
Coordinates are limb-major `int32[L, N]` (G1) or `int32[L, 2, N]` (G2),
< 2p with exact digits in and out.

Plain versions, beside each wrapper: K4/K5 run the stacked RCB path of
`groth16_tpu/curves/point.py:CurveDevice.add` (a = 0) or the generic-a
program of curves/formulas.py (a != 0); K6/K7 transcribe
`pallas_point.mixed_add_g1_math` and its Fp2 form; Horner runs the
programs of its kernel in a loop (c doublings and an addition a window),
the capture step from_affine, the generic-a program and the select, the
scalar multiplication the same programs in its kernel's windows (the
table, the top digit, the skipped zero digits).  Their
multiplies run the plain version of K1 (or Python ints for a few points
on the CPU), so they are plain PyTorch on any device.  The kernels
repeat the same operations in the same order and return the same
digits.

Each wrapper dispatches by device only: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from groth16_tpu_torch.curves import formulas
from groth16_tpu_torch.fields.cuda_fp import (
    KERNEL_LIMBS,
    KERNEL_WORDS,
    check_operand,
    kernel_consts,
    word_consts,
)
from groth16_tpu_torch.fields.ops import Fp2Ops, Fp3Ops, FpOps
from groth16_tpu_torch.fields.spec import FpSpec

# launches per kernel, counted where the kernel is launched and nowhere
# else
LAUNCHES = {
    "add_g1": 0, "add_g2": 0, "horner_g1": 0, "horner_g2": 0, "add_mixed_g1": 0, "add_mixed_g2": 0,
    "scalar_mul_g1": 0, "scalar_mul_g2": 0, "capture_step_g1": 0, "capture_step_g2": 0,
}
# calls of the plain versions on CUDA tensors (the main path makes none)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
# the launches of LAUNCHES that ran the generic-a law (a != 0), by kernel
# and by the coordinate field's degree
GENERAL_A_LAUNCHES = {
    f"{name}_d{d}": 0 for name in ("add", "capture_step", "horner", "scalar_mul") for d in (1, 2, 3)
}
# the additions' launches by points a launch, and the most points of one
# launch
SIZE_CLASSES = ("1-4", "5-4096", ">4096")
LAUNCH_SIZES = {
    name: dict.fromkeys(SIZE_CLASSES, 0)
    for name in ("add_g1", "add_g2", "add_mixed_g1", "add_mixed_g2", "capture_step_g1", "capture_step_g2")
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
def _plain_ops(spec: FpSpec, nr, deg: int = 2):
    """Field ops on K1's plain version: Fq (nr None), Fq2 or Fq3 (deg)."""
    if nr is None:
        return FpOps(spec, plain=True)
    return (Fp2Ops if deg == 2 else Fp3Ops)(spec, nr, plain=True)


def plain_ops(k):
    """The plain twin of field ops k: the same field, its products on K1's
    plain version on any device."""
    return _plain_ops(k.spec, getattr(k, "nr_int", None), k.tower_deg)


def a_is_zero(a_val) -> bool:
    return not any(a_val) if isinstance(a_val, tuple) else a_val == 0


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
        lib._g16_typed = True
    return lib


def _general_lib(n_limbs: int, deg: int, nr: int):
    """The generic-a group kernel's library (csrc/general_add.cu)."""
    from groth16_tpu_torch.utils.cuda_build import general_add_variant, library

    lib = library(general_add_variant(n_limbs, deg, nr))
    if not getattr(lib, "_g16_typed", False):
        P, LL, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint)
        lib.g16_general_add.argtypes = [P] * 9 + [LL, U, P]
        lib.g16_general_add.restype = ctypes.c_int
        lib.g16_general_capture_step.argtypes = (
            [P] * 8 + [LL, ctypes.c_int] + [P] * 5 + [LL, ctypes.c_int, U, P]
        )
        lib.g16_general_capture_step.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def _horner_lib(n_limbs: int):
    """The library of the Horner and scalar-multiplication kernels at L
    (csrc/horner.cu)."""
    from groth16_tpu_torch.utils.cuda_build import horner_variant, library

    lib = library(horner_variant(n_limbs))
    if not getattr(lib, "_g16_typed", False):
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        tail = [P, P, I, I, P, I, I, ctypes.POINTER(ctypes.c_uint), P]  # dbl .. stream
        lib.g16_horner.argtypes = [P] * 6 + [LL, I, I, I] + tail
        lib.g16_horner.restype = ctypes.c_int
        lib.g16_scalar_mul.argtypes = [P] * 7 + [LL, I, I, I] + tail
        lib.g16_scalar_mul.restype = ctypes.c_int
        lib._g16_typed = True
    return lib


def _words(v: int, W: int) -> list:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(W)]


@functools.lru_cache(maxsize=None)
def general_words(spec: FpSpec, D: int, nr, a_val, b3_val):
    """The generic-a group kernel's launch constants (csrc/general_add.cu:
    read_consts): p and -p^-1 mod 2^32 (K1's), one (R mod p), b3's
    constant of each component (Montgomery form, W words each, three),
    a's multipliers, the components a and b3 read (three each, zero
    past D) and a's largest multiplier."""
    W = KERNEL_WORDS[spec.n_limbs]
    a_mult, a_src, b_vals, b_src = formulas.ga_lanes(spec.modulus, D, nr or 0, a_val, b3_val)
    vals = list(word_consts(spec)) + _words(spec.to_mont_int(1), W)
    for c in range(3):
        vals += _words(spec.to_mont_int(b_vals[c]) if c < D else 0, W)
    for xs in (a_mult, a_src, b_src):
        vals += list(xs) + [0] * (3 - D)
    vals.append(max(a_mult))
    return (ctypes.c_uint * len(vals))(*vals)


@functools.lru_cache(maxsize=None)
def horner_programs(spec: FpSpec, D: int, nr, a_val, b3_val) -> dict:
    """The Horner kernel's launch data for one curve group: its doubling
    and addition programs (curves/formulas.py: programs) encoded on one
    slot space (the addition's slots past its two points moved after the
    doubling's: p2, its second point's first slot), the slots, the
    threads a block (the widest step, in warps), and the constants'
    (slot, W words) records followed by one's W words."""
    dbl, add = formulas.programs(spec, D, nr or 0, a_val, b3_val)
    base, shift = 3 * D, dbl.n_slots - 3 * D

    def remap(slot):
        return slot if slot < base else slot + shift

    W = KERNEL_WORDS[spec.n_limbs]
    consts = []
    for prog, move in ((dbl, lambda x: x), (add, remap)):
        for slot, v in prog.consts.items():
            consts += [move(slot)] + _words(v, W)
    widest = max(formulas.widest(dbl), formulas.widest(add), base)
    return {
        "dbl": formulas.encode(dbl), "add": formulas.encode(add, remap), "p2": remap(base),
        "slots": dbl.n_slots + add.n_slots - base, "threads": 32 * -(-widest // 32),
        "consts": consts + _words(spec.to_mont_int(1), W), "nconsts": len(dbl.consts) + len(add.consts),
    }


@functools.lru_cache(maxsize=None)
def _horner_tensors(spec: FpSpec, D: int, nr, a_val, b3_val, device: torch.device):
    hp = horner_programs(spec, D, nr, a_val, b3_val)
    consts = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in hp["consts"]], dtype=torch.int32)
    return tuple(torch.tensor(hp[k], dtype=torch.int32).to(device) for k in ("dbl", "add")) + (consts.to(device),)


def _device(name, tensors) -> torch.device:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices {devs}")
    return devs.pop()


def _check_kernel(name, spec, nr, deg=2, general=False):
    """(L, D) of a kernel call; raises for a field no kernel is built for:
    the a = 0 law over Fq and over Fq2 with |nr| <= 16, the generic-a law
    over Fq, Fq2 and Fq3 (nr > 0 up to 16 there)."""
    L = spec.n_limbs
    D = 1 if nr is None else deg
    if L not in KERNEL_LIMBS:
        raise ValueError(f"{name}: no kernel for L = {L} (have {KERNEL_LIMBS})")
    if D == 2 and not (nr if general else 1 <= abs(nr) <= 16):
        raise ValueError(f"{name}: no kernel for Fq2 nonresidue {nr}")
    if D == 3 and not (general and 1 <= nr <= 16):
        raise ValueError(f"{name}: no kernel for Fq3 nonresidue {nr} (a = 0: none)")
    return L, D


def _count_general(kind, D, general):
    if general:
        GENERAL_A_LAUNCHES[f"{kind}_d{D}"] += 1


def _launch(name, mixed, spec, nr, deg, b3_val, a_val, p1, p2):
    """Launch one point-add kernel on CUDA coordinates; nr is None for
    G1 (Fq coordinates), the tower's nonresidue for G2 over Fq2 or Fq3
    (deg)."""
    general = not a_is_zero(a_val)
    L, D = _check_kernel(name, spec, nr, deg, general)
    lead = (L,) if D == 1 else (L, D)
    n = max(x.shape[-1] for x in p1 + p2)
    ins = [check_operand(x, lead, n, f"{name} input {i}") for i, x in enumerate(p1 + p2)]
    dev = ins[0].device
    outs = [torch.empty(lead + (n,), dtype=torch.int32, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    lib = None if general else _lib(L, D, mixed, 0 if nr is None else nr)
    ptrs = [x.data_ptr() for x in ins] + [o.data_ptr() for o in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if general:  # the generic-a group kernel on words
        words = general_words(spec, D, nr, a_val, b3_val)
        rc = _general_lib(L, D, nr or 0).g16_general_add(*ptrs, n, words, stream)
    elif mixed and D == 1:  # K6
        form = MIXED_G1_FORMS[mixed_g1_form(n, mixed_g1_waves(L, dev))]
        rc = lib.g16_point_add_mixed_g1(form, *ptrs, n, mixed_word_consts(spec, b3_val), stream)
    else:  # K7, or K4/K5: a lane group a point
        fn = lib.g16_point_add_mixed_group if mixed else lib.g16_point_add_group
        rc = fn(*ptrs, n, kernel_consts(spec, b3_val, dev).data_ptr(), spec.n0inv, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    _count_general("add", D, general)
    LAUNCH_SIZES[name][size_class(n)] += 1
    LARGEST_LAUNCH[name] = max(LARGEST_LAUNCH[name], n)
    return tuple(outs)


def _dispatch(name, mixed, spec, nr, deg, b3_val, a_val, p1, p2):
    dev = _device(name, p1 + p2)
    if dev.type == "cpu":
        if mixed:
            return mixed_add_plain(_plain_ops(spec, nr, deg), b3_val, p1, p2)
        return add_plain(_plain_ops(spec, nr, deg), b3_val, p1, p2, a_val)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return _launch(name, mixed, spec, nr, deg, b3_val, a_val, p1, p2)


def add_g1(spec: FpSpec, b3_val: int, p1, p2, a_val=0):
    """K4: (X1,Y1,Z1) + (X2,Y2,Z2) on [L, N] coordinates (the generic-a
    law where a_val != 0)."""
    return _dispatch("add_g1", False, spec, None, 1, b3_val, a_val, p1, p2)


def add_g2(spec: FpSpec, nr: int, b3_val, p1, p2, a_val=0, deg: int = 2):
    """K5: K4 over Fq2 (deg 2) on [L, 2, N] coordinates, or over Fq3 (deg
    3, the generic-a law only) on [L, 3, N]."""
    return _dispatch("add_g2", False, spec, nr, deg, b3_val, a_val, p1, p2)


def add_mixed_g1(spec: FpSpec, b3_val: int, p1, xy2):
    """K6: (X1,Y1,Z1) + affine (X2,Y2) on [L, N]; affine infinity is
    (0, 0) and passes P1 through."""
    return _dispatch("add_mixed_g1", True, spec, None, 1, b3_val, 0, p1, xy2)


def add_mixed_g2(spec: FpSpec, nr: int, b3_val, p1, xy2):
    """K7: K6 over Fq2 on [L, 2, N] coordinates."""
    return _dispatch("add_mixed_g2", True, spec, nr, 2, b3_val, 0, p1, xy2)


def _horner(name, spec, nr, deg, b3_val, a_val, sums, c: int):
    dev = _device(name, sums)
    if dev.type == "cpu":
        return horner_plain(_plain_ops(spec, nr, deg), b3_val, sums, c, a_val)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    general = not a_is_zero(a_val)
    L, D = _check_kernel(name, spec, nr, deg, general)
    lead = (L,) if D == 1 else (L, D)
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
    hp = horner_programs(spec, D, nr, a_val, b3_val)
    dbl, add, consts = _horner_tensors(spec, D, nr, a_val, b3_val, dev)
    rc = _horner_lib(L).g16_horner(
        *[x.data_ptr() for x in sums], *[o.data_ptr() for o in outs], lanes, W, c, D,
        dbl.data_ptr(), add.data_ptr(), hp["p2"], hp["slots"], consts.data_ptr(), hp["nconsts"],
        hp["threads"], word_consts(spec), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    _count_general("horner", D, general)
    return tuple(outs)


def horner_g1(spec: FpSpec, b3_val: int, sums, c: int, a_val=0):
    """sum_w 2^(c w) sums[.., w] for each lane: window sums (X, Y, Z) each
    [L, lanes, W] (window 0 first) -> points [L, lanes], in one launch."""
    return _horner("horner_g1", spec, None, 1, b3_val, a_val, sums, c)


def horner_g2(spec: FpSpec, nr: int, b3_val, sums, c: int, a_val=0, deg: int = 2):
    """horner_g1 over Fq2 (Fq3): sums [L, deg, lanes, W] -> [L, deg, lanes]."""
    return _horner("horner_g2", spec, nr, deg, b3_val, a_val, sums, c)


# Window bits of the scalar multiplication (csrc/horner.cu:
# scalar_mul_kernel, and its plain version) at every L.  chip_ab.py's
# sweep at the device assembly's G1 [r, s, rs] and G2 s shapes, ms at c =
# 1, 2, 3, 4, 5 (NVIDIA H100 80GB HBM3, 700.00 W): bn254 (L = 18) 1.871,
# 1.686, 1.590, 1.577, 1.580 and 2.486, 2.229, 2.078, 2.045, 2.079;
# bls12_381 (26) 2.627, 2.345, 2.198, 2.148, 2.168 and 3.507, 3.190,
# 2.990, 2.954, 2.966; mnt6_298 (21) 4.029, 3.564, 3.408, 3.295, 3.321
# and (Fq3) 5.006, 4.575, 4.340, 4.267, 4.289; bw6_761 (52) 11.681,
# 10.559, 9.921, 9.625, 9.720 and 9.727, 8.932, 8.356, 8.211, 8.207.  c =
# 4 is the fastest or within 1% of c = 5 at every L.
SCALAR_MUL_WINDOW = 4


def window_digits(bits: torch.Tensor, c: int) -> torch.Tensor:
    """int64 [lanes, ceil(nbits / c)] digits of c-bit windows of bits int32
    [lanes, nbits] little-endian (bit & 1), window 0 first; the top window
    takes the bits left where c does not divide nbits."""
    lanes, nbits = bits.shape
    nw = -(-nbits // c)
    b = torch.nn.functional.pad((bits & 1).long(), (0, nw * c - nbits))
    return (b.reshape(lanes, nw, c) << torch.arange(c, device=bits.device)).sum(-1)


def _scalar_mul(name, spec, nr, deg, b3_val, a_val, pt, bits):
    dev = _device(name, list(pt) + [bits])
    if dev.type == "cpu":
        return scalar_mul_plain(_plain_ops(spec, nr, deg), b3_val, pt, bits, a_val)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    general = not a_is_zero(a_val)
    L, D = _check_kernel(name, spec, nr, deg, general)
    lead = (L,) if D == 1 else (L, D)
    if bits.dim() != 2:
        raise ValueError(f"{name}: expected bits [lanes, nbits], got {tuple(bits.shape)}")
    lanes, nbits = bits.shape
    ins = [check_operand(x, lead, lanes, f"{name} input {i}") for i, x in enumerate(pt)]
    if bits.dtype != torch.int32 or not bits.is_contiguous():
        raise TypeError(f"{name}: expected contiguous int32 bits, got {bits.dtype}")
    c = SCALAR_MUL_WINDOW
    if nbits < 1:
        raise ValueError(f"{name}: needs at least one bit")
    outs = [torch.empty(lead + (lanes,), dtype=torch.int32, device=dev) for _ in range(3)]
    if lanes == 0:
        return tuple(outs)
    hp = horner_programs(spec, D, nr, a_val, b3_val)
    dbl, add, consts = _horner_tensors(spec, D, nr, a_val, b3_val, dev)
    rc = _horner_lib(L).g16_scalar_mul(
        *[x.data_ptr() for x in ins], bits.data_ptr(), *[o.data_ptr() for o in outs], lanes, nbits, c, D,
        dbl.data_ptr(), add.data_ptr(), hp["p2"], hp["slots"], consts.data_ptr(), hp["nconsts"],
        hp["threads"], word_consts(spec), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    _count_general("scalar_mul", D, general)
    return tuple(outs)


def scalar_mul_g1(spec: FpSpec, b3_val: int, pt, bits, a_val=0):
    """bits[l] * P[l] for each lane: points (X, Y, Z) each [L, lanes],
    bits int32 [lanes, nbits] little-endian -> [L, lanes], in one launch
    (windows of SCALAR_MUL_WINDOW bits)."""
    return _scalar_mul("scalar_mul_g1", spec, None, 1, b3_val, a_val, pt, bits)


def scalar_mul_g2(spec: FpSpec, nr: int, b3_val, pt, bits, a_val=0, deg: int = 2):
    """scalar_mul_g1 over Fq2 (Fq3): points [L, deg, lanes] -> [L, deg, lanes]."""
    return _scalar_mul("scalar_mul_g2", spec, nr, deg, b3_val, a_val, pt, bits)


def _capture_step(name, spec, nr, deg, b3_val, a_val, acc, xy, cap, jk, src, k_prev, add):
    dev = _device(name, list(acc) + (list(xy) if add else []))
    if dev.type == "cpu":
        return capture_step_plain(_plain_ops(spec, nr, deg), b3_val, a_val, acc, xy, cap, jk, src, k_prev, add)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if a_is_zero(a_val):
        raise ValueError(f"{name}: the capture step is the generic-a law's (a != 0)")
    L, D = _check_kernel(name, spec, nr, deg, True)
    lead = (L,) if D == 1 else (L, D)
    n = acc[0].shape[-1]
    ins = [check_operand(x, lead, n, f"{name} accumulator {i}") for i, x in enumerate(acc)]
    rows = [check_operand(x, lead, n, f"{name} row {i}") for i, x in enumerate(xy)] if add else ins[:2]
    T = 0
    if cap is not None:
        T = cap[0].shape[-1]
        cap = [check_operand(x, lead, T, f"{name} capture {i}") for i, x in enumerate(cap)]
        for x, what in ((jk, "jk"), (src, "src")):
            if x.dtype != torch.int32 or tuple(x.shape) != (T,) or not x.is_contiguous():
                raise ValueError(f"{name}: {what} must be contiguous int32 [{T}]")
    outs = [torch.empty(lead + (n,), dtype=torch.int32, device=dev) for _ in range(3)] if add else ins
    if (n == 0 or not add) and T == 0:
        return tuple(outs), None if cap is None else tuple(cap)
    null = [None] * 5
    tail = [x.data_ptr() for x in cap] + [jk.data_ptr(), src.data_ptr()] if T else null
    rc = _general_lib(L, D, nr or 0).g16_general_capture_step(
        *[x.data_ptr() for x in ins + rows], *[o.data_ptr() for o in outs], n, int(add), *tail, T,
        k_prev, general_words(spec, D, nr, a_val, b3_val), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
    _count_general("capture_step", D, True)
    if add:
        LAUNCH_SIZES[name][size_class(n)] += 1
        LARGEST_LAUNCH[name] = max(LARGEST_LAUNCH[name], n)
    return tuple(outs), None if cap is None else tuple(cap)


def capture_step_g1(spec: FpSpec, b3_val: int, a_val, acc, xy, cap=None, jk=None, src=None, k_prev=-1,
                    add=True):
    """One step of the generic-a capture scan on [L, n] coordinates: acc +
    affine xy ((0, 0) at infinity) where `add` (else acc unchanged), and
    cap[t] = acc[src[t]] for the targets t < T with jk[t] == k_prev (cap
    [L, T], jk and src int32 [T]; on the card cap is written in place).
    Returns (acc', cap')."""
    return _capture_step("capture_step_g1", spec, None, 1, b3_val, a_val, acc, xy, cap, jk, src, k_prev, add)


def capture_step_g2(spec: FpSpec, nr: int, b3_val, a_val, acc, xy, cap=None, jk=None, src=None, k_prev=-1,
                    add=True, deg: int = 2):
    """capture_step_g1 over Fq2 (Fq3): coordinates [L, deg, n]."""
    return _capture_step("capture_step_g2", spec, nr, deg, b3_val, a_val, acc, xy, cap, jk, src, k_prev, add)


# -- plain versions --------------------------------------------------------------


def _group(k) -> str:
    return "g1" if k.tower_deg == 1 else "g2"


def _count_plain(k, mixed, x):
    if x.is_cuda:
        PLAIN_CALLS[("add_mixed_" if mixed else "add_") + _group(k)] += 1


def add_plain(k, b3_val, p1, p2, a_val=0):
    """Plain version of K4/K5: the stacked RCB complete addition of
    `groth16_tpu/curves/point.py:CurveDevice.add` (a = 0), or its generic-a
    law `_add_general` where a_val != 0 (add_general_plain).

    Value ledger (multiples of p): pre-adds < 4p; M1 products <= 16p^2;
    t3/t4/t5 < 6p; t0t < 6p; M2 <= 6p^2; Z3s/t1m < 4p; M3 products
    <= 36p^2; X3/Y3/Z3 pre-reduce < 4p."""
    if not a_is_zero(a_val):
        return add_general_plain(k, b3_val, a_val, p1, p2)
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


def add_general_plain(k, b3_val, a_val, p1, p2):
    """Plain version of the generic-a group kernel (csrc/general_add.cu):
    RCB algorithm 1 of eprint 2015/1060 (the JAX package's
    `CurveDevice._add_general`, groth16_tpu/curves/point.py:200) in the
    kernel's order, curves/formulas.py:general_add: three product rounds
    (6 tower products, 2 by b3, 6), the products by a and by the
    nonresidue as small multiples.  The same points mod p as the JAX
    package's law, coordinate for coordinate; other representatives."""
    _count_plain(k, False, p1[0])
    prog = formulas.programs(k.spec, k.tower_deg, getattr(k, "nr_int", 0), a_val, b3_val)[1]
    return formulas.run_plain(prog, (p1, p2))


def horner_plain(k, b3_val, sums, c: int, a_val=0):
    """Plain version of the Horner kernel (csrc/horner.cu): from res =
    (0 : 1 : 0), for each window from the top, c runs of the doubling
    program and one of the addition program on (res, sums[.., w])
    (curves/formulas.py: programs), in the kernel's order."""
    X = sums[0]
    if X.is_cuda:
        PLAIN_CALLS[f"horner_{_group(k)}"] += 1
    dbl, add = formulas.programs(k.spec, k.tower_deg, getattr(k, "nr_int", 0), a_val, b3_val)
    lanes, W = X.shape[-2:]
    res = (
        k.zero((lanes,), device=X.device),
        k.one((lanes,), device=X.device).contiguous(),
        k.zero((lanes,), device=X.device),
    )
    for w in reversed(range(W)):
        for _ in range(c):
            res = formulas.run_plain(dbl, (res,))
        res = formulas.run_plain(add, (res, tuple(x[..., w].contiguous() for x in sums)))
    return res


def capture_step_plain(k, b3_val, a_val, acc, xy, cap=None, jk=None, src=None, k_prev=-1, add=True):
    """Plain version of the capture step: cap[t] = acc[src[t]] where jk[t]
    == k_prev (the select of groth16_tpu/msm/scans.py), then acc + the
    affine row through from_affine (infinity where y = 0 mod p in every
    component: (0 : 1 : 0), else (x : y : 1)) and add_general_plain."""
    if acc[0].is_cuda:
        PLAIN_CALLS[f"capture_step_{_group(k)}"] += 1
    if cap is not None and k_prev >= 0:
        take = jk == k_prev
        cap = tuple(torch.where(take, x[..., src.long()], y) for x, y in zip(acc, cap))
    if add:
        x2, y2 = xy
        shape = x2.shape[k.coord_ndim :]
        inf = k.is_zero(y2, bound_k=2)
        zero, one = k.zero(shape, device=x2.device), k.one(shape, device=x2.device)
        p2 = (k.select(inf, zero, x2), k.select(inf, one, y2), k.select(inf, zero, one))
        acc = add_general_plain(k, b3_val, a_val, acc, p2)
    return acc, cap


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def scalar_mul_plain(k, b3_val, pt, bits, a_val=0):
    """Plain version of the scalar-multiplication kernel (csrc/horner.cu:
    scalar_mul_kernel) with windows of c = SCALAR_MUL_WINDOW bits:
    the table T[j] = j P (T[2j] = dbl(T[j]), T[2j + 1] = add(T[2j], P)),
    then per lane res = T of its top non-zero digit ((0 : 1 : 0) where all
    are zero) and, for each lower window, c doublings and, where its digit
    d != 0, the addition of T[d]: the programs of curves/formulas.py in
    the kernel's order, so its digits.  The same points mod p as the
    select loop of `groth16_tpu/curves/point.py:CurveDevice.scalar_mul_bits`,
    in other representatives."""
    X = pt[0]
    if bits.is_cuda:
        PLAIN_CALLS[f"scalar_mul_{_group(k)}"] += 1
    dbl, add = formulas.programs(k.spec, k.tower_deg, getattr(k, "nr_int", 0), a_val, b3_val)
    c = SCALAR_MUL_WINDOW
    lanes, dev = X.shape[-1], X.device
    digits = window_digits(bits, c).to(dev)
    table = [tuple(pt)]  # table[j - 1] = T[j]
    for j in range(2, 1 << c):
        if j % 2:
            table.append(formulas.run_plain(add, (table[j - 2], table[0])))
        else:
            table.append(formulas.run_plain(dbl, (table[j // 2 - 1],)))
    stacked = [torch.stack(xs, dim=-1) for xs in zip(*table)]  # [*coords, lanes, 2^c - 1]
    lane = torch.arange(lanes, device=dev)

    def entry(d):  # T[d] of each lane (T[1] where d = 0, unused)
        return tuple(x[..., lane, (d - 1).clamp(min=0)].contiguous() for x in stacked)

    res = (k.zero((lanes,), device=dev), k.one((lanes,), device=dev).contiguous(), k.zero((lanes,), device=dev))
    started = torch.zeros(lanes, dtype=torch.bool, device=dev)
    for w in reversed(range(digits.shape[1])):
        d = digits[:, w]
        nz = d != 0
        if bool(started.any()):
            r = res
            for _ in range(c):
                r = formulas.run_plain(dbl, (r,))
            if bool((started & nz).any()):
                r = _where(nz, formulas.run_plain(add, (r, entry(d))), r)
            res = _where(started, r, res)
        res = _where(~started & nz, entry(d), res)
        started = started | nz
    return res


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
