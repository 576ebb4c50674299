"""Build and load the CUDA kernels of `csrc/` (nvcc -> plain-C shared
library -> ctypes).

Each library is built at first use into `groth16_tpu_torch/_build/`,
named by a hash of its sources and flags, so an edited source is never
served from a stale build.  `build(...)` starts one nvcc per library,
all at once, and returns each build's seconds and the `-Xptxas -v`
report (registers, spills) that nvcc printed.  Nothing here runs when a
module is imported: the CPU tests import every module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HEADERS = ("field.cuh", "point.cuh")

# library variant name -> (source file, extra nvcc defines)
_LIBS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "mont_mul": ("mont_mul.cu", ()),
    "ubench_ops": ("ubench_ops.cu", ()),
}


# From this many digits on, the scans K2/K3 (one thread a column, 15-bit
# digits) call the Montgomery product instead of inlining it
# (csrc/field.cuh: G16_OUTLINE_MUL): inlined, an L = 26 one-thread kernel
# on digits took ptxas 12-15 minutes.  The group forms (K4, K5, K7) and the
# Horner kernel inline it at every L (each has one call site).
OUTLINE_MUL_MIN_LIMBS = 26
# From this many digits on, K6 (one thread a point on 32-bit words) calls
# its word product instead of inlining its 13 copies (csrc/field.cuh:
# G16_OUTLINE_MUL_W): inlined, its L = 26 library builds in ~16 s, its
# L = 52 one about five times as long as called (PERF.md).
OUTLINE_MUL_W_MIN_LIMBS = 52


def _formula_defines(n_limbs: int, deg: int, nr: int) -> Tuple[str, ...]:
    return (f"-DG16_LIMBS={n_limbs}", f"-DG16_D={deg}", f"-DG16_NR={nr}")


def point_add_variant(n_limbs: int, deg: int, mixed: bool, nr: int = 0) -> str:
    """Library of one point-add kernel: G1 over Fq (deg 1, L digits) or G2
    over Fq2 = Fq[u]/(u^2 - nr) (deg 2), full (K4/K5) or mixed (K6/K7)."""
    if deg == 1:
        nr = 0  # the G1 kernels never read it: one library for every curve
    name = f"point_add_L{n_limbs}_d{deg}_{'mixed' if mixed else 'full'}_nr{nr}".replace("-", "m")
    defines = _formula_defines(n_limbs, deg, nr) + (f"-DG16_MIXED={int(mixed)}",)
    if mixed and deg == 1 and n_limbs >= OUTLINE_MUL_W_MIN_LIMBS:
        defines += ("-DG16_OUTLINE_MUL_W",)
    _LIBS.setdefault(name, ("point_add.cu", defines))
    return name


def suffix_scan_variant(n_limbs: int, deg: int, nr: int = 0) -> str:
    """Library of one MSM suffix-scan kernel: K2 (G1, deg 1) or K3 (G2,
    deg 2)."""
    if deg == 1:
        nr = 0
    name = f"suffix_scan_L{n_limbs}_d{deg}_nr{nr}".replace("-", "m")
    defines = _formula_defines(n_limbs, deg, nr)
    if n_limbs >= OUTLINE_MUL_MIN_LIMBS:
        defines += ("-DG16_OUTLINE_MUL",)
    _LIBS.setdefault(name, ("suffix_scan.cu", defines))
    return name


def curve_variants(c) -> list:
    """Every library the prove and the device setup of curve c (a
    CurveParams) load: K1, the full and the mixed point additions and the
    suffix scan over Fq (G1), and, where G2 lies over Fq2 (BN, BLS12), the
    same three over Fq2 with the curve's nonresidue.  Where G2 lies over
    Fq itself (BW6-761) it runs G1's libraries with its own b3 (a row of
    the constant table), so nothing over Fq2 is built."""
    from groth16_tpu_torch.fields.spec import make_spec

    n_limbs = make_spec(c.p).n_limbs
    if c.g2_over_base:
        degs, nr = (1,), 0
    elif c.g2_field_degree == 2:
        degs, nr = (1, 2), c.fp2_nonresidue
    else:
        raise ValueError(f"{c.name}: no kernels for G2 over a degree-{c.g2_field_degree} field")
    return (
        ["mont_mul"]
        + [point_add_variant(n_limbs, deg, mixed, nr) for deg in degs for mixed in (False, True)]
        + [suffix_scan_variant(n_limbs, deg, nr) for deg in degs]
    )


_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _target(name: str) -> Tuple[str, list, str]:
    src, defines = _LIBS[name]
    flags = ARCH_FLAGS + BASE_FLAGS + list(defines)
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (src,) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    return out, flags, os.path.join(CSRC, src)


def library_path(name: str) -> str:
    """Where library `name` is (or will be) built."""
    return _target(name)[0]


def build(names: Iterable[str]) -> Dict[str, Dict]:
    """Build the named libraries that are not built yet, one nvcc each,
    all started together.  Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out, flags, src = _target(name)
        if os.path.exists(out):
            continue
        # nvcc writes a file of this process's own that is renamed once
        # the build passed, so an interrupted build never leaves a
        # library behind and two processes never write one file
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (
            out,
            tmp,
            time.time(),
            subprocess.Popen(
                [_nvcc()] + flags + ["-o", tmp, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    failed, reports = [], {}

    def wait(name):  # one thread a build, so each build's seconds are its own
        out, tmp, t0, proc = procs[name]
        log, _ = proc.communicate()
        reports[name] = {"seconds": time.time() - t0, "ptxas": log}

    waiters = [threading.Thread(target=wait, args=(name,)) for name in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (out, tmp, _, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{reports[name]['ptxas']}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out = _target(name)[0]
        if not os.path.exists(out):
            build([name])
        lib = ctypes.CDLL(out)
        _loaded[name] = lib
    return lib
