"""How `correct` is decided: every proof the run produced against the
plain reference's exact proof for the same assignment, r and s, the
program's verifying key against the reference's, each assignment row by
row against the circuit, and the proof randomness for repeats.  Each
number has its limit; all limits are 0 (exact comparisons)."""

from __future__ import annotations

from benchmark.lib.draw import job_assignment
from benchmark.reference.groth16 import Reference

# proofs checked a run at most: every one up to this, else a sample drawn
# from the seed, the first and the last always in it
MAX_CHECKED = 64

LIMITS = {
    "proofs_differing": 0,
    "proofs_missing": 0,
    "vk_points_differing": 0,
    "unsatisfied_rows": 0,
    "rs_repeated": 0,
    "circuit_digest_differs": 0,
}


def norm(x):
    """Points as nested tuples of ints (None for infinity)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    return int(x)


def vk_points(vk) -> list:
    if isinstance(vk, dict):
        get = vk.__getitem__
    else:
        def get(k):
            return getattr(vk, k)
    return [get("alpha_g1"), get("beta_g2"), get("gamma_g2"), get("delta_g2")] + list(get("gamma_abc_g1"))


def sample(n: int, rng) -> list:
    """Indices of the proofs to check out of n."""
    if n <= MAX_CHECKED:
        return list(range(n))
    return sorted({0, n - 1} | set(rng.sample(range(1, n - 1), MAX_CHECKED - 2)))


def compare(cfg, spec, waste, circuit, digest, pool, jobs, proofs, vk, rng=None) -> dict:
    """jobs: (pool index, r, s, fresh) of every proof asked for
    (draw.draw_job); proofs: what came back, in order (None where nothing
    did); rng draws the sample where there are more than MAX_CHECKED.  ->
    {name: {value, limit}}."""
    ref = Reference(spec, waste, circuit)
    checked = sample(len(jobs), rng)
    evs = {}
    for k in checked:
        key = (jobs[k][0], jobs[k][3])
        if key not in evs:
            evs[key] = ref.evaluate(job_assignment(pool, jobs[k]))
    first = next(iter(evs.values())) if evs else ref.evaluate(pool[0])
    want_vk = [norm(p) for p in vk_points(ref.verifying_key(first))]
    got_vk = [norm(p) for p in vk_points(vk)]
    vk_diff = sum(a != b for a, b in zip(want_vk, got_vk)) + abs(len(want_vk) - len(got_vk))
    missing = sum(1 for k in range(len(jobs)) if k >= len(proofs) or proofs[k] is None)
    differing = 0
    for k in checked:
        i, r, s, fresh = jobs[k]
        got = proofs[k] if k < len(proofs) else None
        if got is not None and norm(got) != norm(ref.proof(evs[i, fresh], job_assignment(pool, jobs[k]), r, s)):
            differing += 1
    pinned = cfg["circuit"].get("matrices_sha256")
    values = {
        "proofs_differing": differing,
        "proofs_missing": missing,
        "vk_points_differing": vk_diff,
        "unsatisfied_rows": sum(ev["unsatisfied_rows"] for ev in evs.values()),
        "rs_repeated": len(jobs) - len({(r, s) for _, r, s, _ in jobs}),
    }
    if pinned:
        values["circuit_digest_differs"] = int(digest != pinned)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
