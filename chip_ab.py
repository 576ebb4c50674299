#!/usr/bin/env python3
"""Time this checkout of the PyTorch/CUDA port against another one on the
same card, in turns.

    git archive <commit> | tar -x -C scratch/parent
    python3 chip_ab.py --other scratch/parent

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
  prove log_n    steady prove_encoded_host wall times of the bn254 2^16
                 and bls12_381 2^20 DummyCircuits (chip_smoke.py's), in
                 PROVE_ROUNDS rounds of turns;
  profile log_n  one steady prove under torch.profiler: device time by
                 kernel name, in turns (also on the capture scan, K6/K7,
                 at both sizes).

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
        for curve in ("bn254", "bls12_381"):
            c = get_curve(curve)
            names.update(cuda_build.curve_variants(c))
        t0 = time.time()
        cuda_build.build(sorted(names))
        return {"build_s": time.time() - t0}

    def setup(self, curve, log_n, device_setup, seed):
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
        self.keys[log_n] = (c, prover, z_enc, Rng(seed + 1))
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from groth16_tpu_torch.config import configure

        c, prover, z_enc, rng = self.keys[log_n]
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        with configure(msm_fused_scan=fused):
            prover.prove_encoded_host(z_enc, r, s)  # the path's first run
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prover.prove_encoded_host(z_enc, r, s)
                self.torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
        return {"device_busy_ms": sum(us for _, us in by_name.values()) / 1e3,
                "top": [[k[:110], n, us / 1e3] for k, (n, us) in top]}

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
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker_main(args.worker)
        return 0
    if not args.other:
        ap.error("--other is required")
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

    try:
        print(smi("name,power.limit"), flush=True)
        both(op="build")
        both(op="setup", curve="bn254", log_n=16, device_setup=False, seed=0xBE7C)
        for L, log_n, h in K1_CASES:
            turns(op="k1", L=L, log_n=log_n, h=h)
        for n in K7_N:
            turns(op="mixed", g2=True, n=n)
        for n in K6_N:
            turns(op="mixed", g2=False, n=n)
        for who in ("other", "this"):
            send(who, op="sass", variants=SASS_LIBS)
            print(json.dumps({"sass": who, **recv(who)}), flush=True)
        for _ in range(PROVE_ROUNDS):
            turns(op="prove", log_n=16, k=PROVES)
        for fused in (True, False):
            for who in ("other", "this", "this", "other"):
                send(who, op="profile", log_n=16, fused=fused)
                print(json.dumps({"profile16": who, "fused": fused, **recv(who)}), flush=True)
        both(op="setup", curve="bls12_381", log_n=20, device_setup=True, seed=0xB15)
        for n in K6_N:
            turns(op="mixed", g2=False, n=n, log_n=20)
        for _ in range(PROVE_ROUNDS):
            turns(op="prove", log_n=20, k=PROVES // 2)
        for fused in (True, False):
            for who in ("other", "this", "this", "other"):
                send(who, op="profile", log_n=20, fused=fused)
                print(json.dumps({"profile20": who, "fused": fused, **recv(who)}), flush=True)
        print(smi("name,power.limit"), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main())
