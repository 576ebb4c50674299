"""Native C++ host engine for the verify path.

Builds (once, cached by source hash) and loads `src/pairing.cpp` — a
fixed-width u64 Montgomery implementation of the tower pairing
(BN/BLS12 families), small G1 MSM and batch subgroup checks — and
exposes it behind the same value conventions as the exact Python engine
(`groth16_tpu_torch.ref`): ints in [0, p), Fp12 as nested tuples.

Reference behavior covered: `Pairing::multi_miller_loop` +
`final_exponentiation` (arkworks-rs/groth16 src/verifier.rs:49-64),
`prepare_inputs` (verifier.rs:25-39), and ark-serialize's
`Validate::Yes` subgroup checks.  The pairing value is canonical, so
outputs are bit-identical to the Python engine; tests pin this.

Set GROTH16_TPU_NO_NATIVE=1 to disable (pure-Python fallback).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from typing import List, Optional, Sequence

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "pairing.cpp")
_CACHE_DIR = os.path.join(
    os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")), "g16_native"
)


def _build_so() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = os.path.join(_CACHE_DIR, f"g16_pairing_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    except Exception as e:  # compiler missing / failed: fall back to Python
        print(f"# g16 native build failed ({e}); using Python engine", file=sys.stderr)
        return None
    return so


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if os.environ.get("GROTH16_TPU_NO_NATIVE"):
        return None
    so = _build_so()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    lib.g16_ctx_new.restype = ctypes.c_void_p
    lib.g16_ctx_new.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.g16_ctx_free.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.g16_multi_pairing.restype = ctypes.c_int
    lib.g16_multi_pairing.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p, u64p, u8p, u64p]
    lib.g16_multi_miller.restype = ctypes.c_int
    lib.g16_multi_miller.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p, u64p, u8p, u64p]
    lib.g16_g1_msm.restype = ctypes.c_int
    lib.g16_g1_msm.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p, u8p, u64p, u64p, u8p]
    lib.g16_g1_subgroup_check.restype = ctypes.c_int
    lib.g16_g1_subgroup_check.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p, u8p, u64p]
    lib.g16_g2_subgroup_check.restype = ctypes.c_int
    lib.g16_g2_subgroup_check.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u64p, ctypes.c_int, u64p, u8p, u64p,
    ]
    lib.g16_tate_ctx_new.restype = ctypes.c_void_p
    lib.g16_tate_ctx_new.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.g16_tate_multi_pairing.restype = ctypes.c_int
    lib.g16_tate_multi_pairing.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u64p, u64p, u8p, u64p,
    ]
    return lib


def _limbs(x: int, nl: int) -> List[int]:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(nl)]


def _unlimbs(arr: Sequence[int]) -> int:
    out = 0
    for i, v in enumerate(arr):
        out |= int(v) << (64 * i)
    return out


class NativePairing:
    """ctypes handle for one curve's native pairing context.

    Supports the Fp12-tower families (bn, bls12) with twist type D/M.
    Construction raises ValueError for unsupported curves — callers use
    `native_pairing(curve)` which returns None instead.
    """

    def __init__(self, curve_name: str):
        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.ref.field import towers

        lib = _lib()
        if lib is None:
            raise ValueError("native library unavailable")
        c = get_curve(curve_name)
        if c.family not in ("bn", "bls12") or c.twist_type not in ("D", "M"):
            raise ValueError(f"native pairing unsupported for {curve_name}")
        self.c = c
        self._lib = lib
        p = c.p
        self.nl = nl = (p.bit_length() + 63) // 64
        k2, k6, k12 = towers(curve_name)
        self.k12 = k12

        r_mont = 1 << (64 * nl)
        blob: List[int] = []
        blob += _limbs(p, nl)
        blob += _limbs(r_mont * r_mont % p, nl)
        blob += [(-pow(p, -1, 1 << 64)) % (1 << 64)]
        blob += _limbs(c.fp2_nonresidue % p, nl)
        for v in c.xi:
            blob += _limbs(v % p, nl)
        b2_3 = (3 * c.b2[0] % p, 3 * c.b2[1] % p)
        for v in b2_3:
            blob += _limbs(v, nl)
        for i in (1, 2, 3):
            g = k2.pow(c.xi, (pow(p, i) - 1) // 6)
            blob += _limbs(g[0], nl) + _limbs(g[1], nl)
        if c.family == "bn":
            tail = [
                k2.pow(c.xi, (p - 1) // 3),
                k2.pow(c.xi, (p - 1) // 2),
                k2.pow(c.xi, (p * p - 1) // 3),
                k2.pow(c.xi, (p * p - 1) // 2),
            ]
        else:
            tail = [(0, 0)] * 4
        for g in tail:
            blob += _limbs(g[0], nl) + _limbs(g[1], nl)
        blob += _limbs(abs(c.ate_loop_count), nl)
        # base-p digits of the hard exponent (<= 4 for k=12 curves)
        digits = []
        e = c.final_exp_hard
        while e:
            digits.append(e % p)
            e //= p
        assert 1 <= len(digits) <= 4, "hard exponent must fit 4 base-p digits"
        blob += [len(digits), 1 if c.ate_loop_is_negative else 0,
                 1 if c.family == "bn" else 0, 1 if c.twist_type == "D" else 0]
        for d in digits:
            blob += _limbs(d, nl)

        arr = (ctypes.c_uint64 * len(blob))(*blob)
        self._ctx = lib.g16_ctx_new(nl, arr)
        if not self._ctx:
            raise ValueError("native ctx init failed")

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.g16_ctx_free(ctx)
            self._ctx = None

    # -- marshalling --------------------------------------------------------

    def _pack_pairs(self, g1s, g2s):
        nl, p = self.nl, self.c.p
        n = len(g1s)
        g1_flat: List[int] = []
        g2_flat: List[int] = []
        inf = []
        for pt, qt in zip(g1s, g2s):
            dead = pt is None or qt is None
            inf.append(1 if dead else 0)
            if dead:
                g1_flat += [0] * (2 * nl)
                g2_flat += [0] * (4 * nl)
            else:
                g1_flat += _limbs(pt[0] % p, nl) + _limbs(pt[1] % p, nl)
                g2_flat += (
                    _limbs(qt[0][0] % p, nl) + _limbs(qt[0][1] % p, nl)
                    + _limbs(qt[1][0] % p, nl) + _limbs(qt[1][1] % p, nl)
                )
        return (
            n,
            (ctypes.c_uint64 * len(g1_flat))(*g1_flat),
            (ctypes.c_uint64 * len(g2_flat))(*g2_flat),
            (ctypes.c_uint8 * n)(*inf),
        )

    def _gt_from_limbs(self, out):
        nl = self.nl
        vals = [_unlimbs(out[i * nl:(i + 1) * nl]) for i in range(12)]
        return (
            ((vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5])),
            ((vals[6], vals[7]), (vals[8], vals[9]), (vals[10], vals[11])),
        )

    # -- API ----------------------------------------------------------------

    def multi_pairing(self, g1s, g2s):
        """final_exponentiation(multi_miller_loop(pairs)) — the verify
        equation's left side (verifier.rs:49-64)."""
        n, a1, a2, inf = self._pack_pairs(g1s, g2s)
        out = (ctypes.c_uint64 * (12 * self.nl))()
        rc = self._lib.g16_multi_pairing(self._ctx, n, a1, a2, inf, out)
        if rc != 0:
            raise RuntimeError(f"g16_multi_pairing rc={rc}")
        return self._gt_from_limbs(out)

    def pairing(self, p_pt, q_pt):
        return self.multi_pairing([p_pt], [q_pt])

    def g1_msm(self, bases, scalars):
        """sum_i scalars[i] * bases[i]; affine or None (infinity)."""
        nl, p, r = self.nl, self.c.p, self.c.r
        n = len(bases)
        flat: List[int] = []
        inf = []
        sc: List[int] = []
        for b, s in zip(bases, scalars):
            inf.append(1 if b is None else 0)
            if b is None:
                flat += [0] * (2 * nl)
            else:
                flat += _limbs(b[0] % p, nl) + _limbs(b[1] % p, nl)
            sc += _limbs(s % r, nl)
        out = (ctypes.c_uint64 * (2 * nl))()
        out_inf = (ctypes.c_uint8 * 1)()
        rc = self._lib.g16_g1_msm(
            self._ctx, n,
            (ctypes.c_uint64 * len(flat))(*flat),
            (ctypes.c_uint8 * n)(*inf),
            (ctypes.c_uint64 * len(sc))(*sc),
            out, out_inf,
        )
        if rc != 0:
            raise RuntimeError(f"g16_g1_msm rc={rc}")
        if out_inf[0]:
            return None
        return (_unlimbs(out[0:nl]), _unlimbs(out[nl:2 * nl]))

    def g1_subgroup_check(self, points) -> int:
        """Number of points NOT in the r-order subgroup (0 = all good)."""
        nl, p = self.nl, self.c.p
        n = len(points)
        flat: List[int] = []
        inf = []
        for b in points:
            inf.append(1 if b is None else 0)
            flat += [0] * (2 * nl) if b is None else (
                _limbs(b[0] % p, nl) + _limbs(b[1] % p, nl)
            )
        rl = _limbs(self.c.r, nl)
        return self._lib.g16_g1_subgroup_check(
            self._ctx, n,
            (ctypes.c_uint64 * len(flat))(*flat),
            (ctypes.c_uint8 * n)(*inf),
            (ctypes.c_uint64 * nl)(*rl),
        )

    def g2_subgroup_check(self, points) -> int:
        """Number of G2 points NOT in the r-order subgroup.  Points are
        affine with coordinates in the G2 field (ints for degree 1,
        degree-length tuples otherwise)."""
        nl, p, c = self.nl, self.c.p, self.c
        deg = 1 if c.g2_over_base else c.g2_field_degree
        a2 = getattr(c, "a2", None)
        if a2 is None:
            a2_coords = [0] * deg
        elif isinstance(a2, int):
            a2_coords = [a2 % p] + [0] * (deg - 1)
        else:
            a2_coords = [v % p for v in a2]

        def coords(v):
            return [v % p] if deg == 1 else [x % p for x in v]

        n = len(points)
        flat: List[int] = []
        inf = []
        for b in points:
            inf.append(1 if b is None else 0)
            if b is None:
                flat += [0] * (2 * deg * nl)
            else:
                for v in coords(b[0]) + coords(b[1]):
                    flat += _limbs(v, nl)
        a2_flat: List[int] = []
        for v in a2_coords:
            a2_flat += _limbs(v, nl)
        rl = _limbs(c.r, nl)
        out = self._lib.g16_g2_subgroup_check(
            self._ctx, deg,
            (ctypes.c_uint64 * len(a2_flat))(*a2_flat),
            n,
            (ctypes.c_uint64 * len(flat))(*flat),
            (ctypes.c_uint8 * n)(*inf),
            (ctypes.c_uint64 * nl)(*rl),
        )
        if out < 0:
            raise RuntimeError("g16_g2_subgroup_check bad degree")
        return out


class NativeTate:
    """Native Tate engine for the BW6/MNT families: GT = Kh[v]/(v^2-u),
    Kh = Fq[u]/(u^d - nr), Miller loop over the scalar-field order
    (mirrors groth16_tpu_torch.ref.pairing.RefPairingTate's projective path
    bit-for-bit)."""

    def __init__(self, curve_name: str):
        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.ref.pairing import RefPairingTate

        lib = _lib()
        if lib is None:
            raise ValueError("native library unavailable")
        c = get_curve(curve_name)
        if c.family not in ("bw6", "mnt4", "mnt6"):
            raise ValueError(f"native Tate engine unsupported for {curve_name}")
        self.c = c
        self._lib = lib
        # reuse the Python engine for untwisting (2 Kh muls per verify)
        # and as the k12-compatible GT context
        self._py = RefPairingTate(curve_name)
        self.k12 = self._py.kgt
        self.d = d = self._py.d
        p = c.p
        self.nl = nl = (p.bit_length() + 63) // 64

        kh = self._py.kh
        nr = c.fp2_nonresidue % p
        r_mont = 1 << (64 * nl)
        blob: List[int] = []
        blob += _limbs(p, nl)
        blob += _limbs(r_mont * r_mont % p, nl)
        blob += [(-pow(p, -1, 1 << 64)) % (1 << 64)]
        blob += _limbs(nr, nl)
        blob += _limbs(c.a % p, nl)
        blob += _limbs(c.r, nl)
        digits = []
        e = (p**d + 1) // c.r
        assert e * c.r == p**d + 1, "r must divide q^d + 1 (Tate hard part)"
        while e:
            digits.append(e % p)
            e //= p
        assert 1 <= len(digits) <= 4
        blob += [len(digits), d]
        for dig in digits:
            blob += _limbs(dig, nl)
        u = tuple([0, 1] + [0] * (d - 2))
        for k in range(1, len(digits)):
            qk = pow(p, k)
            assert (qk - 1) % d == 0
            for i in range(d):
                blob += _limbs(pow(nr, i * ((qk - 1) // d), p), nl)
            vcoef = kh.pow(u, (qk - 1) // 2)
            for v in vcoef:
                blob += _limbs(v % p, nl)

        arr = (ctypes.c_uint64 * len(blob))(*blob)
        self._ctx = lib.g16_tate_ctx_new(nl, arr)
        if not self._ctx:
            raise ValueError("native tate ctx init failed")

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.g16_ctx_free(ctx)
            self._ctx = None

    def multi_pairing(self, g1s, g2s):
        nl, p, d = self.nl, self.c.p, self.d
        n = len(g1s)
        g1_flat: List[int] = []
        q_flat: List[int] = []
        inf = []
        for pt, qt in zip(g1s, g2s):
            dead = pt is None or qt is None
            inf.append(1 if dead else 0)
            if dead:
                g1_flat += [0] * (2 * nl)
                q_flat += [0] * (2 * d * nl)
            else:
                g1_flat += _limbs(pt[0] % p, nl) + _limbs(pt[1] % p, nl)
                xq3, yq3 = self._py.untwist(qt)
                for v in xq3:
                    q_flat += _limbs(v % p, nl)
                for v in yq3:
                    q_flat += _limbs(v % p, nl)
        out = (ctypes.c_uint64 * (2 * d * nl))()
        rc = self._lib.g16_tate_multi_pairing(
            self._ctx, n,
            (ctypes.c_uint64 * len(g1_flat))(*g1_flat),
            (ctypes.c_uint64 * len(q_flat))(*q_flat),
            (ctypes.c_uint8 * n)(*inf),
            out,
        )
        if rc == 2:  # Miller value was zero: Python returns None here
            return None
        if rc != 0:
            raise RuntimeError(f"g16_tate_multi_pairing rc={rc}")
        vals = [_unlimbs(out[i * nl:(i + 1) * nl]) for i in range(2 * d)]
        return (tuple(vals[:d]), tuple(vals[d:]))

    def pairing(self, p_pt, q_pt):
        return self.multi_pairing([p_pt], [q_pt])

    # G1/G2 ops share the tower engine's entry points (the context
    # carries the curve's a coefficient, so MNT's a != 0 works)
    g1_msm = NativePairing.g1_msm
    g1_subgroup_check = NativePairing.g1_subgroup_check
    g2_subgroup_check = NativePairing.g2_subgroup_check


@functools.lru_cache(maxsize=None)
def native_pairing(curve_name: str):
    """The native engine for a curve, or None (unsupported / disabled)."""
    for cls in (NativePairing, NativeTate):
        try:
            return cls(curve_name)
        except ValueError:
            continue
    return None
