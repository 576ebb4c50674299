"""Helpers the per-layer readers of benchmark/metrics share.  A reader
returns None where its cell gives it nothing to read; it never returns 0
for a share of a roofline."""

from __future__ import annotations

from benchmark.work import counts


def phase_mean(ctx, *names):
    """Mean over the phase-timed proves of the sum of the named phases."""
    phases = ctx.get("phases") or []
    if not phases:
        return None
    return sum(sum(p[n] for n in names) for p in phases) / len(phases)


def phase_device_mean(ctx, *names):
    """Mean over the phase-timed proves of the device's busy seconds inside
    the named phases' fences (the union of its kernel and copy intervals,
    from the profiler's trace)."""
    busy = ctx.get("phase_device") or []
    if not busy:
        return None
    return sum(sum(b[n] for n in names) for b in busy) / len(busy)


def traced(ctx, entry):
    """The profiled stretch's summary, where the cell's entry is `entry`."""
    t = ctx.get("trace")
    if ctx.get("entry") != entry or not t or t["busy_s"] <= 0:
        return None
    return t


def witness_map_bound_s(work) -> float:
    fr = work["r"]
    ops = counts.witness_map_ops(work["domain"], work["nnz"], counts.limbs(fr))
    nbytes = counts.witness_map_bytes(work["num_variables"], work["nnz"], work["domain"],
                                      counts.packed_bytes(fr))
    return counts.bound_s(ops, nbytes)


def msm_bound_s(work) -> float:
    """The five MSMs: each at its own best window, its points' additions
    at the configuration's products an addition; bytes: each live point
    (affine) and its scalar read once."""
    bits, Lq = work["r"].bit_length(), counts.limbs(work["p"])
    prod = work["products"]
    g1_add = counts.add_word_ops(Lq, prod["g1_add_products"])
    g2_add = counts.add_word_ops(Lq, prod["g2_add_products"])
    ops = sum(counts.msm_ops(n, bits, g1_add) for n in work["msm_g1_points"])
    ops += counts.msm_ops(work["msm_g2_points"], bits, g2_add)
    qb, rb = counts.packed_bytes(work["p"]), counts.packed_bytes(work["r"])
    nbytes = sum(work["msm_g1_points"]) * (2 * qb + rb) + work["msm_g2_points"] * (2 * work["g2_deg"] * qb + rb)
    return counts.bound_s(ops, nbytes)
