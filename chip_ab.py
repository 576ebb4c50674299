#!/usr/bin/env python3
"""Time this checkout of the PyTorch/CUDA port against another one on the
same card, in turns.

    git archive <commit> | tar -x -C scratch/parent
    python3 chip_ab.py --other scratch/parent [--only GROUP,GROUP,...]

Starts one worker process per checkout (each imports `groth16_tpu_torch`
from its own root and builds its own kernels), has both set up the same
proving keys, then sends every measurement to the workers in the order
other, this, this, other, one at a time, so that only one of them uses
the card at once.  Measurements (all on CUDA tensors, through the
package's public functions, so each checkout runs its own path):

  k1 L log_n h   fp.mont_mul of two [L, n] operands, or of [L, n/h, h]
                 against an [L, 1, h] operand (the NTT's twiddle shape;
                 h = 1: a constant): device time of one call, calls queued
                 behind a spin kernel (the host's launch gaps drop out);
  mixed g2 n     the mixed addition (add_affine: K7 for G2, K6 for G1) of
                 n key points, queued the same way (K6 at L = 18 on the
                 2^16 bn254 key's points and at L = 26 on the 2^20
                 bls12_381 key's, also at the points of the capture
                 proves' K6 launches);
  sass           instruction counts of the mixed additions' kernels;
  general        the generic-a full addition (MNT: G1 over Fq at L = 21,
                 MNT4-298's G2 over Fq2 with NR = 17, MNT6-298's over Fq3)
                 of n points, and the affine step (add_affine: where a !=
                 0 the capture step, or the rebuilt projective point's
                 addition), at the MNT6-298 2^20 and MNT4-298 2^16 capture
                 proves' step widths and at 2^16, queued;
  horner         the Horner entry at every MSM shape (lanes, c, windows)
                 of the bn254 2^16, bls12_381 2^20, bw6_761 2^16 and
                 mnt6_298 2^20 proves, queued, with its time a chain
                 addition;
  prove log_n    steady prove_encoded_host wall times of the bn254 2^16
                 and bls12_381 2^20 DummyCircuits (chip_smoke.py's), and
                 of the mnt6_298 2^20 bench circuit, in PROVE_ROUNDS rounds
                 of turns;
  profile log_n  one steady prove under torch.profiler (the card's events
                 alone): device time by kernel name, the launches and the
                 busy share, in turns (also on the capture scan, K6/K7, at
                 both sizes; mnt6_298 2^20 takes the capture scan);
  scalar_mul     CurveDevice.scalar_mul_bits at the device assembly's three
                 shapes (G1 [r, s, rs] and [s, r], G2 s at the curve
                 order's width) on bn254, bls12_381, bw6_761, mnt4_298 and
                 mnt6_298, queued; then, on this checkout alone, the
                 scalar-multiplication kernel at each window width c of
                 SCALAR_MUL_WINDOWS at the same shapes (its points equal
                 at every c);
  assembly       the device assembly (prover_torch.assembly_phase) of
                 fixed accumulators beside the host assembly (_assemble)
                 of the same ones, host clock around a device sync, on
                 the bn254 and bw6_761 2^16 keys; each device proof must
                 equal the host one.

Groups of measurements, in the order they run (GROUPS; --only picks some):
k1, mixed16 (K6/K7 at 2^16 and the SASS), prove16 (proves and profiles),
mixed20, prove20, general, horner, mnt6 (its 2^20 prove and profile),
scalar_mul, assembly.  The keys a group needs are set up on first use.
One JSON line per measurement and worker, then the card's name and power
limit.  Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SPIN_CYCLES = 40_000_000
REPS_QUEUED = 20
K1_CASES = [(18, 15, None), (18, 16, None), (18, 19, None), (18, 20, None), (26, 16, None),
            (26, 20, None), (18, 19, 512), (18, 16, 1), (26, 20, 1)]
K7_N = (1, 4096, 1 << 16, 1 << 17)
# K6: also the points of the capture proves' launches (2^16 bn254:
# 118,784 and 393,216; 2^20 bls12_381: 28,672 and 73,728)
K6_N = (1, 4096, 28672, 1 << 16, 73728, 118784, 393216, 1 << 20)
# the libraries of the mixed additions (K6 at both L, K7) whose SASS is
# compared
SASS_LIBS = ("point_add_L18_d1_mixed_nr0", "point_add_L26_d1_mixed_nr0", "point_add_L18_d2_mixed_nrm1")
PROVES, PROVE_ROUNDS = 4, 3
# the generic-a additions' widths: the widest capture steps of the
# mnt6_298 2^20 prove (G1 86,016, G2 28,672) and the mnt4_298 2^16 one
# (G1 466,944, its widest launch before the capture step), and 2^16
GENERAL_N = {("mnt4_298", "g1"): (1 << 16, 466944), ("mnt6_298", "g1"): (1 << 16, 86016),
             ("mnt4_298", "g2"): (1 << 16,), ("mnt6_298", "g2"): (28672, 1 << 16)}
# the proving keys, set up on first use: name (log_n for the bn254 2^16
# and bls12_381 2^20 proves') -> (curve, log_n, device setup, seed)
KEYS = {16: ("bn254", 16, False, 0xBE7C), 20: ("bls12_381", 20, True, 0xB15),
        "bw6_761_16": ("bw6_761", 16, True, 0xB6), "mnt6_298_20": ("mnt6_298", 20, True, 0x6A)}
GROUPS = ("k1", "mixed16", "prove16", "mixed20", "prove20", "general", "horner", "mnt6", "scalar_mul", "assembly")
# the scalar multiplication's curves, and the window widths swept on this
# checkout
SCALAR_MUL_CURVES = ("bn254", "bls12_381", "bw6_761", "mnt4_298", "mnt6_298")
SCALAR_MUL_WINDOWS = (1, 2, 3, 4, 5)
ASSEMBLY_KEYS = (16, "bw6_761_16")
ASSEMBLY_REPS = 5


# -- worker ----------------------------------------------------------------------


def queued_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(SPIN_CYCLES)
    e[0].record()
    for _ in range(REPS_QUEUED):
        fn()
    e[1].record()
    e[1].synchronize()
    return e[0].elapsed_time(e[1]) / REPS_QUEUED


class Worker:
    def __init__(self, root):
        sys.path.insert(0, root)
        import torch

        import groth16_tpu_torch  # noqa: F401

        if os.path.dirname(os.path.abspath(groth16_tpu_torch.__file__)) != os.path.join(os.path.abspath(root), "groth16_tpu_torch"):
            raise AssertionError("imported the package from another checkout")
        self.torch = torch
        self.dev = torch.device("cuda")
        self.keys = {}

    def build(self):
        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.utils import cuda_build

        names = set()
        for curve in ("bn254", "bls12_381", "bw6_761", "mnt4_298", "mnt6_298"):
            c = get_curve(curve)
            names.update(cuda_build.curve_variants(c))
        t0 = time.time()
        cuda_build.build(sorted(names))
        return {"build_s": time.time() - t0}

    def setup(self, curve, log_n, device_setup, seed, name=None):
        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.protocol.generator import setup
        from groth16_tpu_torch.protocol.generator_torch import setup_device
        from groth16_tpu_torch.protocol.prover_torch import TorchProver
        from groth16_tpu_torch.r1cs.circuits import DummyCircuit
        from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
        from groth16_tpu_torch.utils.rng import Rng

        c = get_curve(curve)
        ncon, nvar = (1 << log_n) - 2, 1 << (log_n - 1)
        t0 = time.time()
        fn = setup_device if device_setup else setup
        pk, _ = fn(DummyCircuit(nvar, ncon), curve, Rng(seed))
        cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
        DummyCircuit(nvar, ncon, a=3, b=5)(cs)
        prover = TorchProver(pk, cs.to_matrices())
        z_enc = prover.encode_assignment(cs.full_assignment())
        self.torch.cuda.synchronize()
        self.keys[name or log_n] = (c, prover, z_enc, Rng(seed + 1))
        return {"setup_s": time.time() - t0}

    def prove(self, log_n, k):
        c, prover, z_enc, rng = self.keys[log_n]
        walls = []
        for _ in range(k):
            r, s = rng.field_element(c.r), rng.field_element(c.r)
            t0 = time.time()
            prover.prove_encoded_host(z_enc, r, s)
            self.torch.cuda.synchronize()
            walls.append(time.time() - t0)
        return {"steady_prove_s": walls}

    def profile(self, log_n, fused=True):
        """One steady prove under torch.profiler, the card's events alone
        (the raw kineto events: a prove of ~10^5 launches takes minutes
        through the profiler's event tree)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from groth16_tpu_torch.config import configure

        c, prover, z_enc, rng = self.keys[log_n]
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        with configure(msm_fused_scan=fused):
            prover.prove_encoded_host(z_enc, r, s)  # the path's first run
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                prover.prove_encoded_host(z_enc, r, s)
                self.torch.cuda.synchronize()
                wall = time.time() - t0
        by_name = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                n, us = by_name.get(e.name(), (0, 0.0))
                by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
        busy = sum(us for _, us in by_name.values()) / 1e3
        return {"device_busy_ms": busy, "profiled_wall_s": wall, "busy_share": busy / 1e3 / wall,
                "launches": sum(n for n, _ in by_name.values()),
                "top": [[k[:110], n, us / 1e3] for k, (n, us) in top]}

    def _points(self, curve, group, n, seed=5):
        """n points of the curve group (64 distinct ones repeated) on the
        card: a projective batch (Z != 1) and the affine one it is added
        to, with infinity, P + P and P + (-P) lanes."""
        import random

        from groth16_tpu_torch.curves import codec
        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.ref.curve import RefGroups

        c, ref = get_curve(curve), RefGroups(curve)
        g = (codec.g2_ops if group == "g2" else codec.g1_ops)(c)
        to = codec.g2_to_device if group == "g2" else codec.g1_to_device
        mul, neg = getattr(ref, f"{group}_mul"), getattr(ref, f"{group}_neg")
        r = random.Random(seed)
        base = getattr(ref, f"{group}_sample")(3)
        pts = [mul(base, r.randrange(1, c.r)) for _ in range(16)]
        lhs = [pts[i % 16] for i in range(64)]
        rhs = [pts[(5 * i + 3) % 16] for i in range(64)]
        lhs[0], rhs[1], rhs[2], rhs[3] = None, None, lhs[2], neg(lhs[3])
        p1 = g.add(to(c, lhs, self.dev), to(c, lhs, self.dev))
        p2 = to(c, rhs, self.dev)
        reps = -(-n // 64)
        grow = lambda pt: tuple(x.repeat(*([1] * (x.dim() - 1)), reps)[..., :n].contiguous() for x in pt)  # noqa: E731
        return g, grow(p1), grow(p2)

    def general(self, curve, group, n):
        """The generic-a full addition and the affine step of n points."""
        g, p1, p2 = self._points(curve, group, n)
        x2, y2, _ = g.to_affine(p2)
        return {"add_ms": queued_ms(lambda: g.add(p1, p2)),
                "affine_step_ms": queued_ms(lambda: g.add_affine(p1, (x2, y2)))}

    def horner(self, key):
        """The Horner entry at each MSM shape of key's prove: its G1 lane
        groups and its G2 MSM, at msm_plan's c and windows."""
        from groth16_tpu_torch.curves import codec
        from groth16_tpu_torch.msm.pippenger import msm_plan

        c, prover, _, _ = self.keys[key]
        dpk = prover.dpk
        shapes = [("g1", pts[2].shape[-2], pts[2].shape[-1]) for pts in dpk.g1_groups]
        shapes.append(("g2", 1, dpk.b_g2_tail[2].shape[-1]))
        out = []
        for group, lanes, n in shapes:
            g = codec.g2_ops(c) if group == "g2" else codec.g1_ops(c)
            plan = msm_plan(g, n, lanes, c.r.bit_length())
            W = plan.n_groups * plan.wg
            _, p1, _ = self._points(c.name, group, lanes * W, seed=7)
            sums = tuple(x.reshape(x.shape[:-1] + (lanes, W)).contiguous() for x in p1)
            ms = queued_ms(lambda: g.horner(sums, plan.c))
            out.append({"group": group, "lanes": lanes, "msm_points": n, "c": plan.c, "windows": W, "ms": ms,
                        "ms_per_chain_addition": ms / (W * (plan.c + 1))})
        return {"shapes": out}

    def _assembly_shapes(self, curve, seed):
        """(group, label, bits) of the device assembly's scalar
        multiplications for a random r and s at the curve order's width."""
        import random

        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.protocol.prover_torch import scalar_bits

        c = get_curve(curve)
        r = random.Random(seed)
        a, b = r.randrange(1, c.r), r.randrange(1, c.r)
        bits = scalar_bits([a, b, a * b % c.r], self.dev)
        bits = self.torch.nn.functional.pad(bits, (0, c.r.bit_length() - bits.shape[1]))
        return [("g1", "[r, s, rs]", bits), ("g1", "[s, r]", self.torch.stack([bits[1], bits[0]])),
                ("g2", "s", bits[1:2].contiguous())]

    def scalar_mul(self, curve, seed=0x5CA1):
        """CurveDevice.scalar_mul_bits at the assembly's shapes, queued."""
        out = []
        for group, label, bits in self._assembly_shapes(curve, seed):
            g, p1, _ = self._points(curve, group, bits.shape[0] + 4, seed=11)
            p1 = tuple(x[..., 4:].contiguous() for x in p1)  # past the special lanes
            ms = queued_ms(lambda: g.scalar_mul_bits(p1, bits))
            out.append({"group": group, "shape": label, "lanes": bits.shape[0], "nbits": bits.shape[1], "ms": ms})
        return {"curve": curve, "shapes": out}

    def scalar_mul_windows(self, curve, windows, seed=0x5CA1):
        """The scalar multiplication at each window width c at the
        assembly's shapes (cuda_point.SCALAR_MUL_WINDOW set to c, then
        restored), queued; its points (decoded on the host) must be equal
        at every c."""
        from groth16_tpu_torch.curves import codec, cuda_point
        from groth16_tpu_torch.curves.params import get_curve

        c = get_curve(curve)
        chosen = cuda_point.SCALAR_MUL_WINDOW
        out = []
        try:
            for group, label, bits in self._assembly_shapes(curve, seed):
                g, p1, _ = self._points(curve, group, bits.shape[0] + 4, seed=11)
                p1 = tuple(x[..., 4:].contiguous() for x in p1)  # past the special lanes
                dec = codec.g2_from_device if group == "g2" else codec.g1_from_device
                points, ms = {}, {}
                for w in windows:
                    cuda_point.SCALAR_MUL_WINDOW = w
                    points[w] = dec(c, g, g.scalar_mul_bits(p1, bits))
                    ms[w] = queued_ms(lambda: g.scalar_mul_bits(p1, bits))
                if any(v != points[windows[0]] for v in points.values()):
                    raise AssertionError(f"{curve} {group} {label}: the points differ between window widths")
                out.append({"group": group, "shape": label, "lanes": bits.shape[0], "nbits": bits.shape[1],
                            "ms_by_c": ms})
        finally:
            cuda_point.SCALAR_MUL_WINDOW = chosen
        return {"curve": curve, "shapes": out}

    def assembly(self, key, reps):
        """The device assembly and the host assembly of one prove's
        accumulators, reps times each with fresh r and s (host clock,
        device synchronised); the proofs must be equal."""
        from groth16_tpu_torch.protocol import prover_torch as pt

        torch = self.torch
        c, prover, z_enc, rng = self.keys[key]
        acc4, b2 = pt.msm_phases(prover.dpk, z_enc)
        device_s, host_s = [], []
        for i in range(reps + 1):  # the first round warms up
            r, s = rng.field_element(c.r), rng.field_element(c.r)
            bits = pt.scalar_bits([r, s, r * s % c.r], prover.device)
            torch.cuda.synchronize()
            t0 = time.time()
            out = pt.assembly_phase(prover.dpk, acc4, b2, bits)
            torch.cuda.synchronize()
            t1 = time.time()
            host = prover._assemble(acc4, b2, r, s)
            t2 = time.time()
            dev = pt.decode_proof_arrays(prover.curve, out)
            if (dev.a, dev.b, dev.c) != (host.a, host.b, host.c):
                raise AssertionError(f"{key}: the device assembly differs from the host assembly")
            if i:
                device_s.append(t1 - t0)
                host_s.append(t2 - t1)
        return {"device_assembly_s": device_s, "host_assembly_s": host_s}

    def k1(self, L, log_n, h):
        import numpy as np

        from groth16_tpu_torch.curves.params import get_curve
        from groth16_tpu_torch.fields import fp
        from groth16_tpu_torch.fields.spec import encode, make_spec

        torch = self.torch
        c = get_curve("bn254" if L == 18 else "bls12_381")
        spec = make_spec(c.r if L == 18 else c.p)
        n = 1 << log_n
        rng = np.random.default_rng(log_n)
        vals = [int.from_bytes(rng.bytes(48), "little") % (4 * spec.modulus) for _ in range(4096)]
        base = torch.from_numpy(encode(vals, spec, mont=False).astype(np.int32)).to(self.dev)
        a = base.repeat(1, n // 4096)
        b = torch.roll(a, 7, dims=1).contiguous()
        if h is None:
            ms = queued_ms(lambda: fp.mont_mul(spec, a, b))
        else:
            a3, tw = a.reshape(L, n // h, h), b[:, :h].reshape(L, 1, h).contiguous()
            ms = queued_ms(lambda: fp.mont_mul(spec, a3, tw))
        return {"ms": ms}

    def sass(self, variants):
        """Instruction counts by mnemonic of each kernel in the built
        libraries `variants` (cuobjdump -sass)."""
        import re
        import shutil

        from groth16_tpu_torch.utils import cuda_build

        tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
        out = {}
        for name in variants:
            sass = subprocess.run([tool, "-sass", cuda_build.library_path(name)], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            fn = None
            for line in sass.splitlines():
                m = re.search(r"Function : \S*?((?:point_add_words|point_add_group|point_add|mont_mul)_kernel)"
                              r"(I(?:L[a-z]n?\d+E)+)?", line)
                if m:
                    fn = out.setdefault(f"{name}:{m.group(1)}{m.group(2) or ''}", {})
                    continue
                m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)", line)
                if m and fn is not None:
                    fn[m.group(1)] = fn.get(m.group(1), 0) + 1
        return {k: {"instructions": sum(v.values()), "by_op": v} for k, v in out.items()}

    def mixed(self, g2, n, log_n=16):
        import torch

        from groth16_tpu_torch.curves import codec

        c, prover, _, _ = self.keys[log_n]
        g = codec.g2_ops(c) if g2 else codec.g1_ops(c)
        src = prover.dpk.b_g2_tail if g2 else tuple(x[..., 0, :] for x in prover.dpk.g1_groups[-1])
        finite = torch.nonzero(~g.is_infinity(src)).reshape(-1)
        idx = finite[torch.arange(n, device=self.dev) % finite.numel()]
        A = tuple(x[..., idx].contiguous() for x in src)
        P1 = g.add(A, tuple(torch.roll(x, 7, dims=-1) for x in A))
        xy = tuple(torch.roll(x, 3, dims=-1).contiguous() for x in A[:2])
        return {"ms": queued_ms(lambda: g.add_affine(P1, xy))}


def worker_main(root):
    # replies go to the original stdout; anything else printed goes to stderr
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    w = Worker(root)
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd.pop("op")
        reply.write(json.dumps(getattr(w, op)(**cmd)) + "\n")
        reply.flush()


# -- orchestrator ----------------------------------------------------------------


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--only", default=",".join(GROUPS), help="comma-separated groups of measurements (GROUPS)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker_main(args.worker)
        return 0
    if not args.other:
        ap.error("--other is required")
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"unknown groups {sorted(only - set(GROUPS))}; have {GROUPS}")
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    procs = {
        who: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", root],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root)
        for who, root in roots.items()
    }

    def send(who, **cmd):
        procs[who].stdin.write(json.dumps(cmd) + "\n")
        procs[who].stdin.flush()

    def recv(who):
        line = procs[who].stdout.readline()
        if not line:
            raise RuntimeError(f"the {who} worker exited")
        return json.loads(line)

    def both(**cmd):  # at once: builds and setups
        for who in procs:
            send(who, **cmd)
        out = {who: recv(who) for who in procs}
        print(json.dumps({"step": cmd, **out}), flush=True)

    def turns(**cmd):  # other, this, this, other
        out = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            send(who, **cmd)
            out[who].append(recv(who))
        print(json.dumps({"measure": cmd, **out}), flush=True)

    keys = set()

    def need(key):  # set a key up in both workers on first use
        if key not in keys:
            curve, log_n, device_setup, seed = KEYS[key]
            both(op="setup", curve=curve, log_n=log_n, device_setup=device_setup, seed=seed,
                 name=None if isinstance(key, int) else key)
            keys.add(key)

    try:
        print(smi("name,power.limit"), flush=True)
        both(op="build")
        if "k1" in only:
            for L, log_n, h in K1_CASES:
                turns(op="k1", L=L, log_n=log_n, h=h)
        if "mixed16" in only:
            need(16)
            for n in K7_N:
                turns(op="mixed", g2=True, n=n)
            for n in K6_N:
                turns(op="mixed", g2=False, n=n)
            for who in ("other", "this"):
                send(who, op="sass", variants=SASS_LIBS)
                print(json.dumps({"sass": who, **recv(who)}), flush=True)
        if "prove16" in only:
            need(16)
            for _ in range(PROVE_ROUNDS):
                turns(op="prove", log_n=16, k=PROVES)
            for fused in (True, False):
                for who in ("other", "this", "this", "other"):
                    send(who, op="profile", log_n=16, fused=fused)
                    print(json.dumps({"profile16": who, "fused": fused, **recv(who)}), flush=True)
        if "mixed20" in only:
            need(20)
            for n in K6_N:
                turns(op="mixed", g2=False, n=n, log_n=20)
        if "prove20" in only:
            need(20)
            for _ in range(PROVE_ROUNDS):
                turns(op="prove", log_n=20, k=PROVES // 2)
            for fused in (True, False):
                for who in ("other", "this", "this", "other"):
                    send(who, op="profile", log_n=20, fused=fused)
                    print(json.dumps({"profile20": who, "fused": fused, **recv(who)}), flush=True)
        if "general" in only:
            for (curve, group), ns in GENERAL_N.items():
                for n in ns:
                    turns(op="general", curve=curve, group=group, n=n)
        if "horner" in only:
            for key in KEYS:
                need(key)
                turns(op="horner", key=key)
        if "mnt6" in only:
            need("mnt6_298_20")
            for _ in range(PROVE_ROUNDS):
                turns(op="prove", log_n="mnt6_298_20", k=PROVES // 2)
            for who in ("other", "this", "this", "other"):
                send(who, op="profile", log_n="mnt6_298_20")
                print(json.dumps({"profile_mnt6_20": who, **recv(who)}), flush=True)
        if "scalar_mul" in only:
            for curve in SCALAR_MUL_CURVES:
                turns(op="scalar_mul", curve=curve)
            for curve in SCALAR_MUL_CURVES:
                send("this", op="scalar_mul_windows", curve=curve, windows=SCALAR_MUL_WINDOWS)
                print(json.dumps({"scalar_mul_windows": "this", **recv("this")}), flush=True)
        if "assembly" in only:
            for key in ASSEMBLY_KEYS:
                need(key)
                turns(op="assembly", key=key, reps=ASSEMBLY_REPS)
        print(smi("name,power.limit"), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main())
