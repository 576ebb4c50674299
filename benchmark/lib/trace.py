"""Reading a torch.profiler trace of the card: which kernels are the
program's and which PyTorch's, the device's busy time as the union of its
intervals, and the idle gaps named by what the host was doing.

The arithmetic follows chip_smoke.py's profile reading (the raw kineto
events, not the profiler's event tree, which takes minutes for ~10^5
launches).  Kineto stamps host and device events on the host's wall clock
(time.time_ns), so the harness's own spans, taken on that clock, name the
gaps.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

# PyTorch's own device work: its native kernels, the cub sorts it calls,
# copies and fills
GLUE = re.compile(r"at::native::|at_cuda_detail::|\bcub::|^Memcpy|^Memset|^void cub|elementwise_kernel|"
                  r"reduce_kernel|index_elementwise|indexSelect|scatter_gather|radixSort|RadixSort")
# other libraries PyTorch carries
LIBRARY = re.compile(r"cublas|cutlass|cudnn|nccl|thrust::|sm90_xmma|gemm|at::|c10::")


def kind(name: str) -> str:
    """"glue" (PyTorch's kernels, copies, fills), "library" (cuBLAS and
    the like) or "port" (the program's own kernels)."""
    if GLUE.search(name):
        return "glue"
    if LIBRARY.search(name):
        return "library"
    return "port"


def is_launch(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@dataclass
class Spans:
    """The harness's host spans on the wall clock: (name, start_ns, end_ns)."""

    items: list = field(default_factory=list)

    def wrap(self, name, fn):
        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.items.append((name, t0, time.time_ns()))
        return spanned

    def at(self, t_ns: int, default: str) -> str:
        """The innermost span holding t_ns (the shortest), else default."""
        best = None
        for name, a, b in self.items:
            if a <= t_ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else default


def device_events(prof):
    """(name, start_ns, end_ns) of every device event of a profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def union(intervals):
    """Merged (start, end) of a list of intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def busy_s(events, t0_ns: int, t1_ns: int) -> float:
    """Seconds of [t0, t1] in which something ran on the device."""
    inside = [(max(s, t0_ns), min(e, t1_ns)) for _, s, e in events if e > t0_ns and s < t1_ns]
    return sum(e - s for s, e in union(inside)) / 1e9


def summarize(events, t0_ns: int, t1_ns: int, proofs: int, spans: Spans, idle_default: str) -> dict:
    """Busy time, launches and device time by kind a proof, the top
    device operations and the longest idle gaps of the window [t0, t1]."""
    inside = [(n, max(s, t0_ns), min(e, t1_ns)) for n, s, e in events if e > t0_ns and s < t1_ns]
    merged = union([(s, e) for _, s, e in inside])
    busy_ns = sum(e - s for s, e in merged)
    by_name, by_kind, launches = {}, {"port": 0, "glue": 0, "library": 0}, 0
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
        by_kind[kind(n)] += e - s
        launches += is_launch(n)
    gaps, prev = [], t0_ns
    for s, e in merged + [[t1_ns, t1_ns]]:
        if s > prev:
            gaps.append((s - prev, spans.at((s + prev) // 2, idle_default)))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "busy_s": busy_ns / 1e9,
        "proofs": proofs,
        "launches": launches,
        "device_ms_by_kind": {k: v / 1e6 for k, v in by_kind.items()},
        "device_ops": [[n[:120], v / 1e9] for n, v in top],
        "idle_gaps": [[name, g / 1e9] for g, name in gaps[:10]],
    }
