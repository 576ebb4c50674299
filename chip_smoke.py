#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (groth16_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  card      the card, torch and CUDA versions; builds every CUDA kernel of
            the bn254, bls12_377, bw6_761, bls12_381, mnt4_298 and mnt6_298
            proves and setups (bw6_761: its L = 52 libraries over Fq only,
            its G2 lying over Fq; MNT: K1 and the generic-a full additions
            at L = 21 over Fq, Fq2 and Fq3) and the op-rate microbenchmark
            from groth16_tpu_torch/csrc (one nvcc per library, all started
            together) with each one's seconds, registers, stack and spills
            (K1's, K6's and K7's, Horner's (csrc/horner.cu, one library an
            L) with the scalar multiplication's, and the generic-a group
            kernel's (csrc/general_add.cu), on lines of their own), and
            beside them the verifier's native C++ engine (g++), which must
            load for all six curves;
  ubench    kernel V (the op-rate microbenchmark) for its seven operations at
            N = 2^20, R = 2048, each held against its plain version (at R = 16
            and at R = 2048) and timed, with the SASS each compiled to and the
            SM clock under load; the measured 32-bit multiply rate (the
            larger of the u32 and i32 multiply rates at R and at 8R) is the
            denominator of every operations bound from here on (the published
            rate is printed beside it);
  setup     exact-engine setup of the bn254 DummyCircuit with a 2^16 domain
            (65,534 constraints, 32,768 variables) from a fixed seed;
  kernels   K1 (mont_mul) and K4-K7 (point additions) at N = 2^16, the
            Horner kernel at every MSM shape of the prove (lanes, c,
            windows; its bound the products of c doublings and an addition
            a window), and
            K2/K3 (the MSM suffix scans) at the shapes of the prove's largest
            G1 window group and of its G2 window group (rows, chunks and every
            step of each column) at the segment count S the card chooses,
            held digit for digit
            against their plain PyTorch versions on the same inputs (taken
            from the proving key's own points, with infinity, P+P, P+(-P)
            and (0, 0) lanes); each timed with CUDA events beside its plain
            version and its bound, the scans also at S = 1 and on the key's
            own (nearly all infinity) rows; K4/K5 also held against the
            plain version at ADD_CHECK_N points and timed over ADD_SWEEP_N
            (launches queued behind a spin kernel, so that the host's
            launch gaps drop out) beside the launch floor (an empty
            kernel); K6 and K7 the same way, and K6 in each of its two
            forms (the word kernel at two occupancies) timed at 2^16-2^20
            points in rounds of turns; the scalar multiplication of the
            device assembly at its shapes (3 and 2 G1 lanes, 1 G2 lane, the
            curve order's bits) and at 33 and 4,101 lanes of 64 bits (a
            lane of zeros, one of ones, one whose point is infinity, the
            others random), each timed beside its bound (its programs'
            products along the chain) and its time a chain op (the
            window table's steps, the doublings and the additions of the
            longest lane) printed beside Horner's a chain addition (the
            plain versions of Horner and of the scalar multiplication at
            up to 8 lanes run on CPU copies of the same inputs);
  reference the prove of a 2^6 DummyCircuit on the card against the exact
            prover, coordinate for coordinate;
  main_path TorchProver(pk, matrices) on cuda with the default fused MSM
            scan: one prove with every launch counter set to 0 just before
            and read just after (K1, K2, K3, K4, K5 and the Horner kernels
            must have launched, no plain version may have run on the card;
            K4/K5's launches by points a launch are printed), then 3 steady
            prove_encoded_host calls, the last one phase-timed, and one
            under torch.profiler (the card's busy time and the kernels that
            take it); every proof must verify with public input 15 and fail
            with 16;
  capture_path  the same prover with msm_fused_scan=False, counters set to
            0 just before and read just after one prove (K6 and K7 must have
            launched), then one under torch.profiler; both proofs must equal
            the main path's for the same r and s; K6 and K7 held against
            their plain versions at the most points of one of their
            launches there, and K6's two forms timed at the points of each
            of its launches there;
  batch     prove_batch of 4 proofs of the same 2^16 assignment with
            distinct r and s (bench.py's batch_prove keys, against steady
            single proves), counted, timed with its peak memory, profiled,
            then counted on the capture path; proofs 0 and 3 equal single
            proves, all verify; on each MSM path a batch dispatched under
            torch.cuda.set_sync_debug_mode("error") (no host sync from the
            first dispatch to the fetch);
  device_assembly  prove(host_assembly=False) at 2^16, counted (the
            scalar multiplication must launch), equal to the host-assembly
            proof; the device assembly alone timed, counted and profiled
            beside the host assembly, to_affine alone; ProofStream(depth=2)
            over 4 jobs yields the host-assembly proofs in order;
  multi_device  the sharded path (groth16_tpu_torch/par/) on the same 2^16
            key: first, in this process, K1 at the four-step NTT's
            shapes on 2 ranks (the twiddle tile, the first stage's
            periodic twiddles, the coset scale) and K2/K3 on a 2-rank key
            shard (the 4-lane stack, the G2 tail's half) at the window
            msm_plan picks for them, against their plain versions and
            timed (their rows also in the kernels line, as
            "sharded_2_ranks"); then its ranks, started by
            par.mesh.run_ranks (the key pickled
            to them): ShardedProver at world size 1 over NCCL, then at 2
            ranks sharing the card over gloo (collectives through host
            copies), each rank's counters set to 0 just before its
            first prove and read just after (the kernels
            of the main path and the scalar multiplication must launch, no
            plain version may run) and timed over a second by phase, with
            its key shard's points and bytes (half the stack at 2 ranks),
            the bytes it handed to each collective and its peak memory;
            every rank's proof must equal the main path's for the same r
            and s and verify; at 2 ranks also ShardedNtt's four
            transforms at 2^16 equal to NttDomain's, msm_sharded_lanes on
            the key's 4-lane stack equal as affine points to
            msm_device_lanes of the whole stack, ElasticProver (a device
            loss injected at attempt 0 shrinks to 1 rank, an injected SDC
            is retried, both to the same proof; localize_faults finds no
            shard), prove_batch_sharded of 4 equal proof by proof to
            prove_batch on one rank, and dryrun_multichip(2) on the card;
  device_setup  protocol.generator_torch.setup_device of the same 2^16 bn254
            circuit with the same seed, counters set to 0 just before and read
            just after (K1, K4, K5 must launch): its key must equal the exact
            setup's element for element;
  bls12_377 bls12_377 (Fq2 nonresidue -5) at 2^16: the port's bench
            (groth16_tpu_torch.bench.run) with a fresh setup on the card,
            its line printed (its verify_engine must be "native"), 64
            sampled points of each query of its key recomputed on the host,
            K1 at its p and r, K4-K7, the Horner kernels, K2/K3 (at S = 1
            and the chosen S, filled and key's rows) and the scalar
            multiplication (the device assembly's shapes) on its key's
            points against their plain versions (NR = -5 in K3, K5, K7,
            Horner G2 and the G2 scalar multiplication), then one fused
            prove counted (K1-K5 and the Horner kernels must launch, no
            plain version on the card), a capture-scan prove (K6, K7) and a
            device-assembled one (the scalar multiplication) with the same
            r and s, counted, equal to the fused proof; every proof
            verifies with public input 15 and fails with 16 (one verify
            timed on the native and on the Python engine); one steady
            prove profiled; a 2^6 proof equals the exact prover's on both
            MSM paths;
  bw6_761   BW6-761 at 2^16 (L = 52 for its 761-bit Fq, L = 26 for its
            377-bit Fr; G2 over Fq, so G2 runs G1's kernels with its own
            b3 and nothing over Fq2 may launch): the port's bench with a
            fresh setup on the card, its line printed (its K1 launches at
            L = 52 are the setup's decode; verify_engine must be "native"),
            64 sampled points of each query recomputed on the host, K1 at
            its p (2^15 and 2^16, a 2^9 period and a constant) and r, K4
            and K6 with G1's and with G2's b3 (K6 has one form at L = 52),
            the Horner kernel and K2 at the prove's shapes and S, and the scalar
            multiplication at the device assembly's shapes, on its key's
            points against their plain versions; one fused prove counted
            (K1, K2, K4 and Horner must launch), a capture-scan one (K6)
            and a device-assembled one (the scalar multiplication, and K1
            at L = 52 in its to_affine) with the same r and s, equal,
            verified with 15 and rejected with 16 (one verify timed on the
            native and the Python engine); one steady prove profiled; a
            2^6 proof equals the exact prover's on both MSM paths; the
            gadget circuit (r1cs/gadget_circuit.py, a BLS12-377 G1
            addition in-circuit) set up and proved on the card, its proof
            equal to the exact prover's, verified and a wrong input
            rejected;
  bls12_381_2p20  the reference's own bench size: the bls12_381 DummyCircuit
            with a 2^20 domain set up on the device, 64 sampled points of each
            query recomputed on the host from the scalars the device built,
            the L = 26 builds of K4-K7 (K4, K5 and K6 with the checks and
            the sweep of the kernels phase, K6's forms too), of the Horner
            kernel, of K2/K3 (at this prove's shapes, every step, timed
            at S = 1 and the chosen S) and of the scalar
            multiplication (the kernels phase's shapes) against their
            plain versions, K3 also timed at the bls12_377 phase's
            K3 shape (NR = -1 beside NR = -5),
            then TorchProver on cuda: one prove with the counters set to 0 just
            before and read just after (K1-K5 and the Horner kernels must
            launch, no plain version on the card; K4/K5's launches by points
            a launch are printed, and K4/K5 held against the plain version
            at 2^17 points and at the most points of one of the prove's
            launches), 2 steady prove_encoded_host
            calls, the last one phase-timed, and one under torch.profiler
            (the busy share, and the device time of each of the port's
            kernels), the proves over the segment sweep, the device
            assembly with the first prove's r and s (counted; its proof
            equal to the fused one; the assembly alone timed beside the
            host's), then the capture
            scan on the same key with the first prove's r and s (counted,
            phase-timed and profiled, its proofs equal to the fused one, K6
            and K7 held against their plain versions at its widest
            launches, K6's two forms timed at the points of each of its
            launches); every proof must verify
            with public input 15 and fail with 16;
  mnt       K1 at L = 21 (both MNT fields, 2^16 and 2^20 elements, a 2^9
            period and a constant) against its plain version, then
            mnt4_298 at 2^16 (a = 2, G2 over Fq2 with nonresidue 17) and
            mnt6_298 at the reference's 2^20 (a = 11, G2 over Fq3, its
            Fr's mixed-radix domain of 2^15 * 35), each: the port's bench
            with a fresh setup on the card (its line printed, verified on
            the native engine), 64 points of each query checked on the
            host, the generic-a group kernel over Fq and over G2's field at
            1-4,101 points and at 2^16 (with the infinity, P + P and
            P + (-P) lanes), its capture step at the bench prove's widest
            step and at 2^16 (rows at infinity, P + P, P + (-P), an
            infinite accumulator, 12,288 capture targets), Horner at the
            prove's MSM shapes and the scalar multiplication at the device
            assembly's, each timed beside its bound; one counted prove (K1
            at L = 21, the generic-a additions and capture steps launch,
            no K2, K3, K6 or K7, no plain version on the card; its profile
            gives the prove's launches and busy share), a
            device-assembled prove with
            the same r and s (equal), both verified with 15 and rejected
            with 16, a steady prove under torch.profiler (the card's events
            only); mnt6_298's mixed-radix fft at the prove's size against a
            direct evaluation at 4 sampled points; a 2^6 proof of each
            curve equal to the exact prover's;
  mnt_recursion  the MNT cycle's recursion circuit: tests/test_gadget_mnt.py's
            inner MNT4-298 proof made on the card (setup_device of
            MySillyCircuit with Rng(0x4427), a = 19, b = 29; counted,
            equal to the exact prover's, verified and a wrong input
            rejected), G1AddCircuit over MNT4-298 set up and proved with
            MNT6-298 (equal to the exact prover's, verified, x + 1
            rejected), then MntVerifierCircuit on the inner proof (69,597
            constraints over MNT6-298's r, no public input): its SETUP
            shape equal to its PROVE shape, setup_device at 2^17 (Fr's
            2-adicity; phase-timed, counted, peak memory, 64 points of each
            query checked on the host), TorchProver (the matrix encode
            timed), one counted prove (K1 at L = 21, the generic-a
            additions and capture steps and Horner launch, no K2, K3, K6
            or K7, no plain version on the card), h equal to the exact
            host witness map, a device-assembled prove equal to the host
            one, both verified with [] on the native and the Python
            engine, the proof of the assignment with the inner input + 1
            (unsatisfied) rejected, 3 steady proves (the last phase-timed),
            one profiled, the witness map's parts timed, the 2^17 fft
            against a direct evaluation at 4 points, and K1 (the B and A
            matvecs' products, 2,542,106 and 1,835,509 elements, and 2^17),
            the generic-a kernel at the prove's widest launches, its
            capture step on the prove's own rows, Horner and the scalar
            multiplication at the prove's shapes against their plain
            versions, timed beside their bounds (the exact witness map and
            the wrong input's synthesis run in two child processes beside
            the card's work).

Then the `kernels` line (every kernel with its launches on each path), the
card's name and power limit as nvidia-smi gives them, and last
`{"ok": true, "device": {...}}`.  Any failed check
raises, so the run exits non-zero without that line; so does a run without
a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CURVE = "bn254"
LOG_N = 16
N_KERNEL = 1 << 16
REPS = 10
BLS_CURVE = "bls12_381"
BLS_LOG_N = 20
B377_CURVE = "bls12_377"
B377_LOG_N = 16
BW6_CURVE = "bw6_761"
BW6_LOG_N = 16
UBENCH_N, UBENCH_R = 1 << 20, 2048

# Published peaks of one H100 SXM (700 W): HBM at 3.35 TB/s; 32-bit
# integer operations (multiply-add included) at 64 per SM per clock and
# float32 ones at 128 (the CUDA programming guide's throughput table for
# compute capability 9.0) on 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9
# The card's own 32-bit multiply rate, measured by the ubench phase (kernel
# V); every operations bound after that phase divides by it.
MEASURED = {"int32_mad_per_s": None}


T0 = time.time()


def emit(obj):
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps({**obj, "t_s": round(time.time() - T0, 3)}), flush=True)


def smi(query: str) -> str:
    """One nvidia-smi reading of the first card, e.g. smi("name,power.limit")."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def ptxas_summary(log: str) -> dict:
    """Registers, stack frame and spill bytes per kernel from nvcc's
    -Xptxas -v report (the kernel's own lines, not those of a function it
    calls)."""
    out, name, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and props == name:
            out.setdefault(name, {}).update(
                stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3))
            )
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def time_ms(fn, reps=REPS):
    """Median of `reps` single-call CUDA-event times (after one warm-up)."""
    import torch

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


def bound(nbytes: float, mads: float) -> dict:
    """Least time for the work: the larger of the bytes over HBM's rate and
    the multiply-adds (utils/profiling.py's counts) over the measured rate
    (bound_ms, bound_by), and the same with the published rate
    (bound_published_ms, bound_published_by)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for key, rate in (("bound", MEASURED["int32_mad_per_s"]), ("bound_published", INT32_MAD_PER_S)):
        t_ops = mads / rate * 1e3
        t, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        out[f"{key}_ms"], out[f"{key}_by"] = t, by
    return out


def point_bound(nbytes: float, adds: int, L: int, fp2: bool = False, mixed: bool = False, g=None) -> dict:
    """bound() of `adds` point additions that move nbytes, their products
    counted on the word engine (utils/profiling.point_add_word_ops: the
    fewest multiply-adds the port does a product in, as K1 and K6 do it),
    and the same with the 15-bit digit count (point_add_u32_ops) beside
    it as bound_15bit_ms and bound_15bit_by.  For curve ops g with a != 0
    (MNT) the generic-a law's counts (point_add_general_*_ops: the
    products that law needs over g's field, 14 over Fq)."""
    from groth16_tpu_torch.utils import profiling as pf

    if g is not None and not g.a_is_zero:
        words, digits = pf.point_add_general_word_ops(g), pf.point_add_general_u32_ops(g)
    else:
        words, digits = pf.point_add_word_ops(L, fp2, mixed), pf.point_add_u32_ops(L, fp2, mixed)
    digit = bound(nbytes, adds * digits)
    return {**bound(nbytes, adds * words),
            "bound_15bit_ms": digit["bound_ms"], "bound_15bit_by": digit["bound_by"]}


def max_abs_err(got, want) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(got, want))


# -- phases ----------------------------------------------------------------------


def phase_card():
    import torch

    import threading

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields.spec import make_spec
    from groth16_tpu_torch.native import native_pairing
    from groth16_tpu_torch.utils import cuda_build

    names = [
        name
        for c in (get_curve(CURVE), get_curve(BLS_CURVE), get_curve(B377_CURVE), get_curve(BW6_CURVE),
                  get_curve(MNT4_CURVE), get_curve(MNT6_CURVE))
        for name in cuda_build.curve_variants(c)
    ] + ["ubench_ops"]
    # the verifier's native engine (g++) builds beside the nvcc wave
    native_s = {}

    def build_native():
        t = time.time()
        native_pairing(CURVE)
        native_s["seconds"] = time.time() - t

    native = threading.Thread(target=build_native)
    t0 = time.time()
    native.start()
    reports = cuda_build.build(dict.fromkeys(names))
    native.join()
    missing = [c for c in (CURVE, B377_CURVE, BLS_CURVE, BW6_CURVE, MNT4_CURVE, MNT6_CURVE)
               if native_pairing(c) is None]
    if missing:
        raise AssertionError(f"the native verifier engine is unavailable for {missing}")
    emit({
        "phase": "card",
        "card": card_line(),
        "clocks_sm_max_sm": smi("clocks.sm,clocks.max.sm"),
        "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": round(time.time() - t0, 3),
        "native_engine_build_s": native_s.get("seconds"),
        "libraries": {
            n: {"seconds": round(r["seconds"], 3), "kernels": ptxas_summary(r["ptxas"])}
            for n, r in reports.items()
        },
    })
    # K1 (each L and vector width), K6 (its forms) and K7 (the mixed G2
    # group form), at each L
    emit({"phase": "card", "k1_k6_k7_ptxas": {
        kernel_name(k): v
        for n, r in reports.items() if n == "mont_mul" or "_mixed_" in n
        for k, v in ptxas_summary(r["ptxas"]).items()
    }})
    # the scalar multiplication and Horner (csrc/horner.cu, both kernels in
    # one library an L)
    emit({"phase": "card", "scalar_mul_horner_ptxas": {
        f"{n}: {kernel_name(k)}": v
        for n, r in reports.items() if n.startswith("horner_")
        for k, v in ptxas_summary(r["ptxas"]).items()
    }})
    # the L = 21 libraries of MNT4-298 and MNT6-298: K1's L = 21 instances
    # are in the mont_mul line above; the generic-a group kernel
    # (csrc/general_add.cu, its projective and capture-step forms) over Fq,
    # Fq2 (NR = 17) and Fq3 (NR = 5)
    emit({"phase": "card", "generic_a_ptxas": {
        f"{n}: {kernel_name(k)}": v
        for n, r in reports.items() if n.startswith("general_add_")
        for k, v in ptxas_summary(r["ptxas"]).items()
    }})


def kernel_name(mangled: str) -> str:
    """"point_add_group_kernel<18, 1, 0, 1, 0>" from a kernel's mangled
    name (template arguments in order; bools as 0 and 1)."""
    m = re.search(r"((?:mont_mul|point_add_group|point_add_words|general_add|horner|scalar_mul)_kernel)I((?:L[a-z]n?\d+E)+)E", mangled)
    if not m:
        return mangled
    args = [a.replace("n", "-") for a in re.findall(r"L[a-z](n?\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def sass_families(path: str) -> dict:
    """Instruction counts per kernel of a built library, by family, from
    `cuobjdump -sass`: IMAD (multiplies; IMAD.MOV and IMAD.SHL are moves
    and shifts, IMAD.IADD an add), IADD (IADD3, IMAD.IADD), and the other
    mnemonics by their base name."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            op = m.group(1)
            if op.startswith(("IMAD.MOV", "IMAD.SHL")):
                fam = "IMAD.MOV/SHL"
            elif op.startswith(("IMAD.IADD", "IADD3")):
                fam = "IADD"
            else:
                fam = op.split(".")[0]
            counts[fn][fam] = counts[fn].get(fam, 0) + 1
    return counts


# per operation of V: the instruction family its chain must compile to, and
# the fewest IMADs and instructions one operation takes (the CIOS step is a
# multiply, a mask and a shift-add (LEA) and a three-input add; the 16-bit
# multiply a multiply and one mask, each new value masked once for its two
# uses).  The bound takes the larger of the IMADs at 64 per SM per clock and
# all instructions at the issue limit, 4 schedulers x 32 lanes = 128 per SM
# per clock (the float32 rate).
UBENCH_SPEC = {
    "u32_mul": ("IMAD", 1, 1),
    "u32_add": ("IADD", 0, 1),
    "u32_cios": ("IMAD", 1, 4),
    "u16_mul": ("IMAD", 1, 2),
    "f32_mul": ("FMUL", 0, 1),
    "f32_fma": ("FFMA", 0, 1),
    "i32_mul": ("IMAD", 1, 1),
}


def smi_during(fn, seconds: float) -> list:
    """nvidia-smi samples (SM clock MHz, power W) every 100 ms while fn()
    is launched back to back for `seconds`."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        t_end = time.time() + seconds
        while time.time() < t_end:
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    return [[float(v) for v in line.split(",")] for line in out.splitlines() if line.strip()]


def phase_ubench(device):
    """Kernel V on the card: each operation held against its plain version
    (R = 16, where the f32 chains stay finite, and the timed R = 2048),
    timed at N = 2^20, R = 2048, its SASS read back.  Sets the measured
    32-bit multiply rate and returns the kernels-line entries."""
    import torch

    from groth16_tpu_torch.utils import cuda_build, ubench

    sass = sass_families(cuda_build.library_path("ubench_ops"))
    n, R = UBENCH_N, UBENCH_R
    rows = {}
    for op in ubench.OPS:
        a, b = ubench.inputs(op.key, n, seed=ubench.OP_INDEX[op.key], device=device)
        # f32: the errors at R = 16, where every chain is still finite
        # (below 1e13; from R = 32 on they overflow), both R held to the
        # relative tolerance
        errs = []
        for r in (16, R):
            got = ubench.chains(op.key, a, b, r)
            want = ubench.chains_plain(op.key, a, b, r)
            torch.cuda.synchronize()
            errs.append(ubench.agree(op.key, got, want))
            if r == 16 and op.kind == "f32":
                rel_err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        fam, imads, instrs = UBENCH_SPEC[op.key]
        counts = sass[f"g16_ubench_{op.key}"]
        if counts.get(fam, 0) < 16:
            raise AssertionError(f"ubench {op.key}: the chain did not compile to {fam}: {counts}")
        plain_ms = time_ms(lambda: ubench.chains_plain(op.key, a, b, R), reps=3)
        per_op_s = max(imads / INT32_MAD_PER_S, instrs / F32_OPS_PER_S)
        rows[op.key] = {"a": a, "b": b, "max_abs_err": errs[0] if op.kind == "f32" else max(errs),
                        "max_rel_err": rel_err if op.kind == "f32" else 0.0,
                        "plain_ms": plain_ms, "sass": counts, "per_op_s": per_op_s}
    # the timed runs, counted: the counters are read just after
    zero_counts()
    for op in ubench.OPS:
        row = rows[op.key]
        row["ms"] = time_ms(lambda: ubench.chains(op.key, row["a"], row["b"], R))
    launches = read_counts([op.key for op in ubench.OPS])
    mul = rows["u32_mul"]
    clocks = smi_during(lambda: ubench.chains("u32_mul", mul["a"], mul["b"], R), 2.0)
    sm_mhz = statistics.median(c[0] for c in clocks) if clocks else None
    rate_of = {k: R * n / (row["ms"] * 1e-3) for k, row in rows.items()}
    # the multiply chains 8x longer: at R the launch, the ramp and the
    # last wave of blocks take part of a 0.16 ms kernel; the measured rate
    # is the larger of the two lengths' rates
    rate_8r = {
        k: 8 * R * n / (time_ms(lambda: ubench.chains(k, rows[k]["a"], rows[k]["b"], 8 * R)) * 1e-3)
        for k in ("u32_mul", "i32_mul")
    }
    MEASURED["int32_mad_per_s"] = max(rate_of["u32_mul"], rate_of["i32_mul"], *rate_8r.values())
    entries = {}
    for op in ubench.OPS:
        row = rows[op.key]
        t_bytes = 3 * 4 * n / HBM_BYTES_PER_S * 1e3
        t_ops = R * n * row["per_op_s"] * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        line = {"kernel": f"V ubench {op.key}", "label": op.label, "n": n, "R": R,
                "tolerance": 0 if op.kind != "f32" else f"rtol {ubench.F32_RTOL}",
                "max_abs_err": row["max_abs_err"], "max_rel_err": row["max_rel_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "g_op_per_s": rate_of[op.key] / 1e9, "share_of_published": t_ops / row["ms"],
                "bound_ms": b_ms, "bound_by": b_by, "bound_published_ms": b_ms, "bound_published_by": b_by,
                "sass": row["sass"]}
        emit({"phase": "ubench", **line})
        entries[f"ubench_{op.key}"] = {
            "name": f"ubench_{op.key}", "route": "cuda", "source": "groth16_tpu_torch/csrc/ubench_ops.cu",
            "replaces": "scripts/ubench_vpu.py:32", "launches": launches[op.key], "path": "ubench",
            "launches_by_path": {"ubench": launches[op.key]}, **_kline(line),
        }
    emit({
        "phase": "ubench", "int32_mad_per_s_measured": MEASURED["int32_mad_per_s"],
        "int32_mad_per_s_published": INT32_MAD_PER_S,
        "int32_mad_per_s_published_at_measured_clock": 132 * 64 * sm_mhz * 1e6 if sm_mhz else None,
        "mul_per_s_at_R": {k: rate_of[k] for k in rate_8r}, "mul_per_s_at_8R": rate_8r,
        "sm_clock_mhz_under_load": sm_mhz, "smi_samples": clocks[:20], "card": card_line(),
    })
    return entries


def phase_setup():
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(CURVE)
    n_constraints, n_vars = (1 << LOG_N) - 2, 1 << (LOG_N - 1)
    rng = Rng(0xBE7C)
    t0 = time.time()
    pk, vk = setup(DummyCircuit(n_vars, n_constraints), CURVE, rng)
    setup_s = time.time() - t0
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(n_vars, n_constraints, a=3, b=5)(cs)
    if not cs.is_satisfied():
        raise AssertionError("the 2^16 assignment does not satisfy its constraints")
    emit({
        "phase": "setup", "curve": CURVE, "log_n": LOG_N, "constraints": n_constraints,
        "variables": n_vars, "setup_s": round(setup_s, 3),
    })
    return pk, vk, cs, rng


def _is_g2(c, g) -> bool:
    """Whether the curve ops g are curve c's G2: over Fq2, or (BW6-761)
    over Fq with G2's b3, which then runs G1's kernels."""
    return g.k.tower_deg >= 2 or (c.g2_over_base and g.b3_val == 3 * c.b2 % c.p)


def _key_points(dpk, g):
    """The proving key's points the kernel checks start from (affine
    uploads, Z = 1): the G2 query for G2, the largest G1 lane group's first
    lane for G1."""
    if _is_g2(dpk.params, g):
        return dpk.b_g2_tail
    return tuple(x[..., 0, :] for x in dpk.g1_groups[-1])


def _kernel_inputs(src, g, n, device):
    """Left (projective, Z != 1) and right (affine-uploaded) batches of n
    points from the finite points of `src`, with the special lanes (those
    below n): 0 = inf + Q, 1 = P + P, 2 = P + (-P), 3 = P + inf.  Returns
    (p1, p2_full, p1m, xy2_mixed) where the mixed pair replaces lanes 1-2
    with affine P and lane 3 with the (0, 0) infinity."""
    import torch

    from groth16_tpu_torch.curves import cuda_point

    m = max(n, 8)
    k = g.k
    plain = cuda_point.plain_ops(k)
    finite = torch.nonzero(~g.is_infinity(src)).reshape(-1)
    idx = finite[torch.arange(m, device=device) % finite.numel()]
    A = tuple(x[..., idx].contiguous() for x in src)  # affine uploads, Z = 1
    B = tuple(torch.roll(x, 7, dims=-1) for x in A)
    P1 = cuda_point.add_plain(plain, g.b3_val, A, B, g.a_val)  # projective, Z != 1
    inf = g.infinity((1,), device=device)

    def put(pt, j, col):
        out = tuple(x.clone() for x in pt)
        for x, v in zip(out, col):
            x[..., j] = v[..., 0]
        return out

    def col(pt, j):
        return tuple(x[..., j : j + 1] for x in pt)

    p2 = tuple(torch.roll(x, 3, dims=-1) for x in A)
    p1 = put(P1, 0, inf)
    p2 = put(p2, 1, col(p1, 1))
    p2 = put(p2, 2, g.neg(col(p1, 2)))
    p2 = put(p2, 3, inf)
    # mixed: affine right operand, (0, 0) for infinity
    p1m = put(put(P1, 1, col(A, 1)), 2, col(A, 2))
    p1m = put(p1m, 0, inf)
    xy = tuple(torch.roll(x, 3, dims=-1) for x in A[:2])
    aff_inf = torch.roll(g.is_infinity(A), 3, dims=-1)
    xy = tuple(torch.where(aff_inf, torch.zeros_like(x), x) for x in xy)
    negy = k.neg(A[1][..., 2:3], k=1)
    xy = put(xy, 1, col(A[:2], 1))
    xy = put(xy, 2, (A[0][..., 2:3], negy))
    xy = put(xy, 3, tuple(torch.zeros_like(x[..., :1]) for x in xy))
    return tuple(tuple(x[..., :n].contiguous() for x in pt) for pt in (p1, p2, p1m, xy))


def phase_kernels(pk, matrices, device):
    """Every kernel against its plain version at N = 2^16; returns the
    per-kernel entries of the kernels line (launches filled in later)."""
    import numpy as np

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.device_keys import upload_proving_key

    c = get_curve(CURVE)
    n = N_KERNEL
    rng = np.random.default_rng(0xC0DE)
    entries = {"mont_mul": _mont_mul_kernel(rng, device)}

    # K4-K7 on bn254 G1 / G2 with the proving key's own points
    dpk = upload_proving_key(pk, matrices, device)
    entries.update(_point_kernels(dpk, c, n, device, mixed=(False, True)))
    _add_sweep(lambda g: _key_points(dpk, g), c, device, ("add_g1", "add_g2", "add_mixed_g1", "add_mixed_g2"))
    _k6_forms(lambda g: _key_points(dpk, g), c, device)
    entries.update(_horner_kernels(_prove_horner_shapes(dpk), c, device))
    entries.update(_scalar_mul_kernels(lambda g: _key_points(dpk, g), c, device, entries, 0x5CA1))
    entries.update(_scan_kernels(dpk, c, rng, device))
    return entries


# K1's checked and timed shapes: (field, log2 n, period h of the second
# operand or None): the 2^16 prove's NTT stages (2^15) and products
# (2^16), the 2^20 prove's (2^19, 2^20), L = 26 at both sizes, and the
# NTT's twiddle shape (h = 2^9) and a constant (h = 1); the first is the
# kernels line's row
K1_SIZES = (
    ("bn254.Fr", 16, None), ("bn254.Fr", 15, None), ("bn254.Fq", 16, None), ("bn254.Fr", 19, None),
    ("bn254.Fr", 20, None), ("bls12_381.Fq", 16, None), ("bls12_381.Fq", 20, None),
    ("bn254.Fr", 19, 1 << 9), ("bn254.Fr", 16, 1),
)
# bls12_377's p and r (L = 26 and 18) at its 2^16 prove's products
K1_SIZES_377 = (("bls12_377.Fq", 16, None), ("bls12_377.Fr", 16, None), ("bls12_377.Fr", 15, None))
# BW6-761's p (L = 52) at 2^16 and 2^15 elements, against a 2^9 period and
# a constant; its r (L = 26) at its 2^16 prove's NTT sizes
K1_SIZES_BW6 = (
    ("bw6_761.Fq", 16, None), ("bw6_761.Fq", 15, None), ("bw6_761.Fq", 16, 1 << 9), ("bw6_761.Fq", 16, 1),
    ("bw6_761.Fr", 16, None), ("bw6_761.Fr", 15, None),
)


def _lazy_operand(rng, spec, n, device):
    """[L, n] lazy operand: digit-wise sums of two exact values < p (4,096
    distinct columns, tiled)."""
    import numpy as np
    import torch

    from groth16_tpu_torch.fields.spec import encode

    return sum(
        torch.from_numpy(encode(
            [int.from_bytes(rng.bytes(max(48, (spec.modulus.bit_length() + 7) // 8)), "little")
             for _ in range(4096)], spec, mont=False
        ).astype(np.int32))
        for _ in range(2)
    ).to(device).repeat(1, max(1, n // 4096))[:, :n].contiguous()


def _k1_row(spec, a, b, n, h, sweep=True) -> dict:
    """K1 on a [L, n] and b ([L, n], or [L, h] read with period h):
    digit-equal to its plain version, then timed (queued_ms) beside it
    and its bound (an [L, h] operand counted once); where `sweep`, also
    at each of the kernel's elements a thread at that L
    (cuda_fp.KERNEL_VECTORS).  -> the row's numbers."""
    import torch

    from groth16_tpu_torch.fields import cuda_fp
    from groth16_tpu_torch.utils.profiling import mont_mul_word_ops

    L = spec.n_limbs
    run = lambda: cuda_fp.mont_mul(spec, a, b, n)  # noqa: E731
    got, want = run(), cuda_fp.mont_mul_plain(spec, a, b, n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K1 at L = {L}, n = {n}, h = {h}: kernel and plain version disagree")
    err = max_abs_err([got], [want])
    del got, want
    ms, queued = queued_ms(run)
    row = {"tolerance": 0, "max_abs_err": err, "ms": ms, "queued_before_spin_ended": queued,
           "elements_per_thread": cuda_fp.elements_per_thread(L, n)}
    if sweep:
        row["ms_by_elements_per_thread"] = {}
        chosen = cuda_fp.elements_per_thread
        try:
            for v in cuda_fp.KERNEL_VECTORS[L]:
                cuda_fp.elements_per_thread = lambda L_, n_, v=v: v  # noqa: E731
                row["ms_by_elements_per_thread"][v] = queued_ms(run)[0]
        finally:
            cuda_fp.elements_per_thread = chosen
    row["plain_ms"] = time_ms(lambda: cuda_fp.mont_mul_plain(spec, a, b, n), reps=3)
    return {**row, **bound((2 * n + (h or n)) * L * 4, n * mont_mul_word_ops(L)), "card": card_line()}


def _mont_mul_kernel(rng, device, sizes=K1_SIZES):
    """K1 at each of `sizes`: digit-equal to its plain version on lazy
    operands (digit-wise sums of two exact values < p), then timed
    (queued_ms) at the wrapper's elements a thread and at each of
    the kernel's elements a thread at that L (cuda_fp.KERNEL_VECTORS); the
    bound counts an [L, h] operand once.  Returns the kernels-line entry
    (the first size's row)."""
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields.spec import make_spec

    entry = None
    for label, log_n, h in sizes:
        curve, field = label.split(".")
        spec = make_spec(get_curve(curve).p if field == "Fq" else get_curve(curve).r)
        n = 1 << log_n
        a, b = (_lazy_operand(rng, spec, n, device) for _ in range(2))
        if h is not None:
            b = b[:, :h].contiguous()
        row = {"kernel": "K1 mont_mul", "field": label, "n": n, "period": h, **_k1_row(spec, a, b, n, h)}
        emit({"phase": "kernels", **row})
        if entry is None:
            entry = {"name": "mont_mul", "route": "cuda", "source": "groth16_tpu_torch/csrc/mont_mul.cu",
                     "replaces": "groth16_tpu/fields/pallas_fp.py:114", **_kline(row)}
    return entry


POINT_KERNELS = {  # name: (tag, mixed, G2, the TPU kernel)
    "add_g1": ("K4", False, False, "groth16_tpu/curves/pallas_point.py:155"),
    "add_g2": ("K5", False, True, "groth16_tpu/curves/pallas_point.py:517"),
    "add_mixed_g1": ("K6", True, False, "groth16_tpu/curves/pallas_point.py:249"),
    "add_mixed_g2": ("K7", True, True, "groth16_tpu/curves/pallas_point.py:496"),
}
# points a launch at which K4/K5 are held against the plain version, and
# at which they are timed
ADD_CHECK_N = (1, 3, 33, 4096 + 5, 1 << 16)
ADD_SWEEP_N = (1, 4, 64, 512, 4096, 1 << 14, 1 << 15, 3 << 14, 1 << 16, 1 << 17)
# SM clocks torch.cuda._sleep holds the card while queued_ms queues the
# launches it times: ~20 ms at the H100's 1.98 GHz boost, far longer than
# the host takes to queue REPS_QUEUED launches
SPIN_CYCLES = 40_000_000
REPS_QUEUED = 20


def queued_ms(fn):
    """Device time of one call of fn: REPS_QUEUED calls queued behind a
    spin kernel, so that they run back to back without the host's launch
    gaps, CUDA events around them; -> (ms a call, whether the host queued
    them all before the spin ended)."""
    import torch

    fn()
    torch.cuda.synchronize()
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    e[1].record()
    t0 = time.time()
    for _ in range(REPS_QUEUED):
        fn()
    host_ms = (time.time() - t0) * 1e3
    e[2].record()
    e[2].synchronize()
    return e[1].elapsed_time(e[2]) / REPS_QUEUED, host_ms < e[0].elapsed_time(e[1])


def _point_kernels(dpk, c, n, device, mixed):
    """The point additions of curve c (the full ones, and the mixed ones
    where `mixed` holds True) against their plain version
    at N = n (or n[name]), on the proving key's own points."""
    import torch

    from groth16_tpu_torch.curves import codec, cuda_point
    from groth16_tpu_torch.fields.spec import make_spec

    L = make_spec(c.p).n_limbs
    entries = {}
    widths = n
    for name, (tag, is_mixed, g2, replaces) in POINT_KERNELS.items():
        if is_mixed not in mixed:
            continue
        n = widths[name] if isinstance(widths, dict) else widths
        g = codec.g2_ops(c) if g2 else codec.g1_ops(c)
        deg = g.k.tower_deg
        if g2 and deg == 1:  # G2 over Fq: G1's kernel (K4, K6) with G2's b3
            g1_tag, _, _, replaces = POINT_KERNELS[name.replace("g2", "g1")]
            tag = f"{g1_tag} (G2's b3)"
        p1, p2, p1m, xy = _kernel_inputs(_key_points(dpk, g), g, n, device)
        plain_ops = cuda_point.plain_ops(g.k)
        add = g.add_affine if is_mixed else g.add
        if is_mixed:
            run = lambda: add(p1m, xy)  # noqa: E731
            run_plain = lambda: cuda_point.mixed_add_plain(plain_ops, g.b3_val, p1m, xy)  # noqa: E731
            # lanes whose affine operand is infinity pass P1 through: no work
            live = int((xy[1].reshape(-1, n) != 0).any(dim=0).sum())
            nbytes = (3 + 2 + 3) * L * deg * 4 * n
        else:
            run = lambda: add(p1, p2)  # noqa: E731
            run_plain = lambda: cuda_point.add_plain(plain_ops, g.b3_val, p1, p2, g.a_val)  # noqa: E731
            live = n
            nbytes = (3 + 3 + 3) * L * deg * 4 * n
        got, want = run(), run_plain()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{tag} {name} on {c.name}: kernel and plain version disagree")
        _check_special_lanes(g, got)
        ms, plain_ms = queued_ms(run)[0], time_ms(run_plain)
        row = {"kernel": f"{tag} {name}", "curve": c.name, "n": n, "live": live, "tolerance": 0,
               "max_abs_err": max_abs_err(got, want), "ms": ms, "plain_ms": plain_ms,
               **point_bound(nbytes, live, L, deg == 2, is_mixed, g=g)}
        emit({"phase": "kernels", **row})
        src = "point_add.cu" if g.a_is_zero else "general_add.cu"
        entries[name] = {
            "name": name, "route": "cuda", "source": f"groth16_tpu_torch/csrc/{src}",
            "replaces": replaces, **_kline(row),
        }
    return entries


def _add_ops(name, c):
    """(curve ops, mixed) of a point-add kernel's name: add_g1, add_g2,
    add_mixed_g1, add_mixed_g2."""
    from groth16_tpu_torch.curves import codec

    g = codec.g2_ops(c) if name.endswith("g2") else codec.g1_ops(c)
    return g, "mixed" in name


def _add_run(name, g, mixed, src, n, device):
    """(kernel call, plain call) of one point-add kernel on n points made
    from src by _kernel_inputs."""
    from groth16_tpu_torch.curves import cuda_point

    plain_ops = cuda_point.plain_ops(g.k)
    p1, p2, p1m, xy = _kernel_inputs(src, g, n, device)
    if mixed:
        return (lambda: g.add_affine(p1m, xy)), (lambda: cuda_point.mixed_add_plain(plain_ops, g.b3_val, p1m, xy))
    return (lambda: g.add(p1, p2)), (lambda: cuda_point.add_plain(plain_ops, g.b3_val, p1, p2, g.a_val))


def _check_adds(src_of, c, device, sizes):
    """Each point-add kernel named in `sizes` (add_g1, add_g2,
    add_mixed_g1, add_mixed_g2) on curve c held digit for digit against its plain
    version at each of sizes[name] points (the special lanes where
    n >= 4); src_of(g): the points the inputs come from.  Returns
    `sizes`."""
    import torch

    for name, ns in sizes.items():
        g, mixed = _add_ops(name, c)
        src = src_of(g)
        for n in ns:
            run, run_plain = _add_run(name, g, mixed, src, n, device)
            got, want = run(), run_plain()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} on {c.name} at n = {n}: differs from the plain version")
            if n >= 4:
                _check_special_lanes(g, got)
    return sizes


def _add_sweep(src_of, c, device, names):
    """The point-add kernels `names` on curve c: checked at ADD_CHECK_N
    points (and 2^17 for K7), then timed (queued_ms) at ADD_SWEEP_N
    points, beside the launch floor (an empty kernel's time, queued and
    alone)."""
    import torch

    from groth16_tpu_torch.fields.spec import make_spec

    checked = _check_adds(src_of, c, device, {
        name: ADD_CHECK_N + ((1 << 17,) if "mixed" in name else ()) for name in names
    })
    sleep0 = lambda: torch.cuda._sleep(0)  # noqa: E731
    floor_ms, queued = queued_ms(sleep0)
    for name in names:
        g, mixed = _add_ops(name, c)
        src, sweep = src_of(g), {}
        for n in ADD_SWEEP_N:
            run, _ = _add_run(name, g, mixed, src, n, device)
            sweep[n], ok = queued_ms(run)
            queued &= ok
        emit({"phase": "kernels", "kernel": f"{name} sweep", "curve": c.name,
              "L": make_spec(c.p).n_limbs, "digit_equal_at_n": checked[name], "tolerance": 0,
              "ms_by_n": sweep, "queued_before_spin_ended": queued,
              "launch_floor_ms": floor_ms, "launch_floor_single_event_ms": time_ms(sleep0),
              "card": card_line()})


# points a launch at which K6's two forms are timed in the kernels and
# bls12_381_2p20 phases (the capture proves time them at their own launch
# sizes), and the rounds of turns
K6_FORM_N = (1 << 16, 1 << 17, 1 << 18, 1 << 20)
K6_FORM_ROUNDS = 3


def _k6_forms(src_of, c, device, sizes=None, check=True, rounds=K6_FORM_ROUNDS):
    """K6 in each of its forms at curve c's L (cuda_point.mixed_g1_forms:
    the word kernel at its natural and at a forced occupancy), held
    against the plain version at 2^16 points where `check`, then timed (queued_ms) at
    each of `sizes` points (K6_FORM_N) in K6_FORM_ROUNDS rounds of turns, beside the
    word and the 15-bit bounds; the points a wave of each form holds on
    the card, the wrapper's form at each size (mixed_g1_form) and whether
    it had the least median time are printed beside them."""
    import torch

    from groth16_tpu_torch.curves import codec, cuda_point
    from groth16_tpu_torch.fields.spec import make_spec
    from groth16_tpu_torch.utils.profiling import point_add_u32_ops, point_add_word_ops

    g, L = codec.g1_ops(c), make_spec(c.p).n_limbs
    sizes = K6_FORM_N if sizes is None else sizes
    src, chosen = src_of(g), cuda_point.mixed_g1_form
    wave = cuda_point.mixed_g1_waves(L, torch.device(device))
    forms = cuda_point.mixed_g1_forms(L)
    ms, bounds, kept = {f: {} for f in forms}, {}, {}
    try:
        for n in sizes:
            run, run_plain = _add_run("add_mixed_g1", g, True, src, n, device)
            want = run_plain() if check and n == 1 << 16 else None
            for form in forms:
                cuda_point.mixed_g1_form = lambda n_, w_, f=form: f  # noqa: E731
                if want is not None:
                    got = run()
                    torch.cuda.synchronize()
                    if not all(torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(f"K6 form {form} on {c.name} at n = {n}: differs from the plain version")
                ms[form][n] = []
            del want
            for _ in range(rounds):
                for form in forms:
                    cuda_point.mixed_g1_form = lambda n_, w_, f=form: f  # noqa: E731
                    ms[form][n].append(queued_ms(run)[0])
            fastest = min(ms, key=lambda f: statistics.median(ms[f][n]))
            kept[n] = {"form": chosen(n, wave), "fastest_by_median": fastest}
            nbytes = 8 * L * 4 * n
            bounds[n] = {"words": bound(nbytes, n * point_add_word_ops(L)),
                         "15bit": bound(nbytes, n * point_add_u32_ops(L))}
    finally:
        cuda_point.mixed_g1_form = chosen
    emit({"phase": "kernels", "kernel": "K6 add_mixed_g1 forms", "curve": c.name, "L": L,
          "digit_equal_at_n": 1 << 16 if check else None, "tolerance": 0,
          "points_a_wave": wave, "ms_by_form_and_n": ms, "kept_form_by_n": kept,
          "bounds_by_n": bounds, "card": card_line()})


def _recording_k6_sizes(prove):
    """prove(), and K6's launches by points a launch while it ran (the
    wrapper asks mixed_g1_form once a launch)."""
    from groth16_tpu_torch.curves import cuda_point

    chosen, seen = cuda_point.mixed_g1_form, {}

    def record(n, wave):
        seen[n] = seen.get(n, 0) + 1
        return chosen(n, wave)

    cuda_point.mixed_g1_form = record
    try:
        return prove(), dict(sorted(seen.items()))
    finally:
        cuda_point.mixed_g1_form = chosen


def _horner_sums(g, src, lanes, W, device):
    """[*coords, lanes, W] projective window sums from the finite points of
    src, with one infinity sum."""
    import torch

    from groth16_tpu_torch.curves import cuda_point

    k = g.k
    plain = cuda_point.plain_ops(k)
    m = lanes * W
    finite = torch.nonzero(~g.is_infinity(src)).reshape(-1)
    idx = finite[torch.arange(m, device=device) % finite.numel()]
    A = tuple(x[..., idx].contiguous() for x in src)
    pts = cuda_point.add_plain(plain, g.b3_val, A, tuple(torch.roll(x, 5, dims=-1) for x in A), g.a_val)
    inf = g.infinity((1,), device=device)
    pts = tuple(torch.cat([i, x[..., 1:]], dim=-1) for i, x in zip(inf, pts))
    return tuple(x.reshape(x.shape[:-1] + (lanes, W)).contiguous() for x in pts)


def _horner_kernels(shapes, c, device):
    """The Horner entry against its plain version (the loop of additions
    it replaces, on the card) at the MSM shapes the prove gives it:
    shapes[name] = [(src points, lanes, n)] for horner_g1 and horner_g2,
    each run at msm_plan's c and window count; timed (queued_ms).  The
    kernel-line numbers are the sums over one prove's calls.  The plain
    version runs on CPU copies of the inputs (plain_run; at most 4 lanes
    at the proves' shapes)."""
    import torch

    from groth16_tpu_torch.curves import codec, cuda_point, formulas
    from groth16_tpu_torch.msm.pippenger import msm_plan
    from groth16_tpu_torch.utils import profiling as pf

    sbits = c.r.bit_length()
    entries = {}
    for name, g in (("horner_g1", codec.g1_ops(c)), ("horner_g2", codec.g2_ops(c))):
        k = g.k
        D, L = k.tower_deg, k.spec.n_limbs
        plain_ops = cuda_point.plain_ops(k)
        calls, err = [], 0
        for src, lanes, n in shapes[name]:
            plan = msm_plan(g, n, lanes, sbits)
            W = plan.n_groups * plan.wg
            sums = _horner_sums(g, src, lanes, W, device)
            got = g.horner(sums, plan.c)
            want, plain_ms = plain_run(
                lambda x: cuda_point.horner_plain(plain_ops, g.b3_val, x, plan.c, g.a_val), (sums,),
                lanes <= PLAIN_CPU_MAX_LANES,
            )
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} on {c.name} (lanes {lanes}, c {plan.c}, {W} windows): kernel and plain version disagree")
            err = max(err, max_abs_err(got, want))
            ms, _ = queued_ms(lambda: g.horner(sums, plan.c))
            adds = lanes * W * (plan.c + 1)
            # the products the chain needs: c doublings and an addition a
            # window, each its program's raw Fq products
            dbl, add = formulas.programs(k.spec, D, getattr(k, "nr_int", 0), g.a_val, g.b3_val)
            products = lanes * W * (plan.c * dbl.n_products + add.n_products)
            nbytes = 3 * D * L * 4 * lanes * (W + 1)
            digit = bound(nbytes, products * pf.mont_mul_u32_ops(L))
            calls.append({"lanes": lanes, "msm_points": n, "c": plan.c, "windows": W, "adds": adds,
                          "products": products, "ms": ms, "ms_per_chain_addition": ms / (W * (plan.c + 1)),
                          "plain_ms": plain_ms, **bound(nbytes, products * pf.mont_mul_word_ops(L)),
                          "bound_15bit_ms": digit["bound_ms"], "bound_15bit_by": digit["bound_by"]})
        row = {"kernel": name, "curve": c.name, "tolerance": 0, "max_abs_err": err, "calls": calls,
               **{key: sum(x[key] for x in calls) for key in ("ms", "plain_ms", "bound_ms", "bound_published_ms")},
               "bound_by": calls[0]["bound_by"], "bound_published_by": calls[0]["bound_published_by"],
               "plain_on": "cpu" if all(x["lanes"] <= PLAIN_CPU_MAX_LANES for x in calls) else "cuda"}
        emit({"phase": "kernels", **row})
        entries[name] = {
            "name": name, "route": "cuda", "source": "groth16_tpu_torch/csrc/horner.cu",
            "replaces": POINT_KERNELS[f"add_g{min(D, 2)}"][3], **_kline(row),
            "ms_per_chain_addition": [x["ms_per_chain_addition"] for x in calls],
        }
    return entries


# capture targets of the capture-step checks: as many as one window
# group's bucket boundaries at c = 13 (lanes x windows x 2^12)
CAPTURE_TARGETS = 3 * 4096


def _capture_call(g, c, acc, xy, cap, jk, src, k_prev, live) -> dict:
    """One capture step of curve ops g (acc + the affine rows xy, and the
    captures cap of the targets jk == k_prev read from acc[src]) against
    its plain version (capture_step_plain: from_affine, the generic-a law
    and the select, on the card), digit for digit, then timed beside its
    bound: `live` additions (the data's work) and the bytes of the
    accumulators, the rows and the captures taken.  The kernel writes the
    captures of a copy of cap in place.  -> the row's numbers."""
    import torch

    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.fields.spec import make_spec

    L, D = make_spec(c.p).n_limbs, g.k.tower_deg
    n, T = acc[0].shape[-1], jk.shape[-1]
    cap_k = tuple(x.clone() for x in cap)
    run = lambda: g.capture_step(acc, xy, cap_k, jk, src, k_prev)  # noqa: E731
    got = run()
    want, plain_ms = timed_once(lambda: cuda_point.capture_step_plain(
        cuda_point.plain_ops(g.k), g.b3_val, g.a_val, acc, xy, cap, jk, src, k_prev))
    torch.cuda.synchronize()
    flat = lambda pair: list(pair[0]) + list(pair[1])  # noqa: E731
    if not all(torch.equal(x, y) for x, y in zip(flat(got), flat(want))):
        raise AssertionError(f"capture step over degree {D} on {c.name} at n = {n}: kernel and plain version disagree")
    taken = int((jk == k_prev).sum())
    nbytes = ((3 + 2 + 3) * n + 2 * 3 * taken) * L * D * 4 + 2 * 4 * T
    return {"n": n, "targets": T, "captured": taken, "max_abs_err": max_abs_err(flat(got), flat(want)),
            "ms": queued_ms(run)[0], "plain_ms": plain_ms, **point_bound(nbytes, live, L, D == 2, g=g)}


def _capture_step_kernels(dpk, c, device, widths):
    """The generic-a group kernel's capture step (_capture_call) of curve
    c's G1 and G2 at each of widths[name] points (the widest capture step
    of the curve's prove, and 2^16), on its key's points with the special
    lanes (rows at infinity, P + P, P + (-P), an infinite accumulator)
    and CAPTURE_TARGETS targets a third of which capture."""
    import numpy as np
    import torch

    from groth16_tpu_torch.curves import codec

    rng = np.random.default_rng(0xCA)
    entries = {}
    for name, g in (("capture_step_g1", codec.g1_ops(c)), ("capture_step_g2", codec.g2_ops(c))):
        src_pts = _key_points(dpk, g)
        calls = []
        for n in widths[name]:
            _, _, acc, xy = _kernel_inputs(src_pts, g, n, device)
            T = CAPTURE_TARGETS
            jk = torch.from_numpy(rng.integers(0, 3, T, dtype=np.int32)).to(device)
            src = torch.from_numpy(rng.integers(0, n, T, dtype=np.int32)).to(device)
            calls.append(_capture_call(g, c, acc, xy, g.infinity((T,), device=device), jk, src, 1, n))
        row = {"kernel": name, "curve": c.name, "tolerance": 0, "max_abs_err": max(x["max_abs_err"] for x in calls),
               "calls": calls, **{k: calls[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                           "bound_published_ms", "bound_published_by")},
               "at_n": calls[0]["n"], "card": card_line()}
        emit({"phase": "kernels", **row})
        entries[name] = {
            "name": name, "route": "cuda", "source": "groth16_tpu_torch/csrc/general_add.cu",
            "replaces": "groth16_tpu/msm/scans.py:192",
            **_kline(row), "at_n": calls[0]["n"],
        }
    return entries


# lanes at which the scalar multiplication is checked and timed beside the
# device assembly's own shapes, and their bits: random, with a lane of
# zeros and a lane of ones (64 of them, a multiple of every window width
# measured but 3 and 5: the plain version's run takes seconds at the
# curve order's width)
SCALAR_MUL_LANES = (33, 4101)
SCALAR_MUL_LANE_BITS = 64


def _scalar_mul_kernels(src_of, c, device, horner, seed, extra_lanes=SCALAR_MUL_LANES):
    """The scalar-multiplication kernel against its plain version (the
    same windows on the same programs, on the CPU or the card), digit for
    digit: at the device assembly's shapes, G1 [r, s, rs] (3 lanes) and
    [s, r] (2 lanes) and G2 s (1 lane), with a random r and s (the curve
    order's width, its top bits zero where the scalars are shorter), and
    at `extra_lanes` lanes of SCALAR_MUL_LANE_BITS bits (lane 2 infinity);
    each timed (queued_ms) beside its bound (its programs' products along
    the chain: latency-bound, as Horner), and its time a chain op (the
    table's steps, the doublings and the additions of the longest lane)
    beside Horner's time a chain addition for the same group (`horner`:
    this curve's Horner entries).  src_of(g): the points the inputs come
    from.  The plain version runs on CPU copies of the inputs up to
    PLAIN_CPU_MAX_LANES lanes (plain_run), on the card past them.  Returns
    the kernels-line entries (the 3-lane G1 and the G2 shapes)."""
    import numpy as np
    import torch

    from groth16_tpu_torch.curves import codec, cuda_point, formulas
    from groth16_tpu_torch.fields.spec import make_spec
    from groth16_tpu_torch.protocol.prover_torch import scalar_bits
    from groth16_tpu_torch.utils import profiling as pf

    rng = np.random.default_rng(seed)
    r, s = (int.from_bytes(rng.bytes(40), "little") % c.r for _ in range(2))
    asm = scalar_bits([r, s, r * s % c.r], device)
    asm = torch.nn.functional.pad(asm, (0, c.r.bit_length() - asm.shape[1]))
    L = make_spec(c.p).n_limbs
    window = cuda_point.SCALAR_MUL_WINDOW
    entries = {}
    for name, g in (("scalar_mul_g1", codec.g1_ops(c)), ("scalar_mul_g2", codec.g2_ops(c))):
        D = g.k.tower_deg
        plain_ops = cuda_point.plain_ops(g.k)
        dbl, add = formulas.programs(g.k.spec, D, getattr(g.k, "nr_int", 0), g.a_val, g.b3_val)
        horner_op = horner[name.replace("scalar_mul", "horner")]["ms_per_chain_addition"]
        src = src_of(g)
        finite = torch.nonzero(~g.is_infinity(src)).reshape(-1)
        shapes = [("assembly [r, s, rs]", asm), ("assembly [s, r]", torch.stack([asm[1], asm[0]]))]
        if _is_g2(c, g):
            shapes = [("assembly s", asm[1:2])]
        for lanes in extra_lanes:
            b = rng.integers(0, 2, (lanes, SCALAR_MUL_LANE_BITS), dtype=np.int32)
            b[0], b[1] = 0, 1
            shapes.append((f"{lanes} lanes", torch.from_numpy(b).to(device)))
        for label, bits in shapes:
            lanes, nbits = bits.shape
            idx = finite[torch.arange(lanes, device=device) % finite.numel()]
            A = tuple(x[..., idx].contiguous() for x in src)
            pts = cuda_point.add_plain(plain_ops, g.b3_val, A, tuple(torch.roll(x, 7, dims=-1) for x in A), g.a_val)
            if lanes > 3:
                inf = g.infinity((1,), device=device)
                pts = tuple(torch.cat([x[..., :2], i, x[..., 3:]], dim=-1) for x, i in zip(pts, inf))
            run = lambda: g.scalar_mul_bits(pts, bits)  # noqa: E731
            got = run()
            plain_cpu = lanes <= PLAIN_CPU_MAX_LANES
            want, plain_ms = plain_run(
                lambda x, b: cuda_point.scalar_mul_plain(plain_ops, g.b3_val, x, b, g.a_val), (pts, bits), plain_cpu
            )
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} on {c.name} ({label}, {nbits} bits): kernel and plain version disagree")
            ms, _ = queued_ms(run)
            # the steps the data needs (each lane's table, doublings and
            # additions) and the launch's chain: the longest lane's steps
            steps = pf.scalar_mul_steps(cuda_point.window_digits(bits.cpu(), window), window)
            chain = max(d + a for d, a in steps)
            products = sum(d * dbl.n_products + a * add.n_products for d, a in steps)
            nbytes = (6 * D * L + nbits) * 4 * lanes
            digit = bound(nbytes, products * pf.mont_mul_u32_ops(L))
            row = {"kernel": name, "curve": c.name, "shape": label, "lanes": lanes, "nbits": nbits, "c": window,
                   "tolerance": 0, "max_abs_err": max_abs_err(got, want), "ms": ms, "plain_ms": plain_ms,
                   "doublings": sum(d for d, _ in steps), "additions": sum(a for _, a in steps),
                   "products": products, "chain_ops": chain, "ms_per_chain_op": ms / chain,
                   "horner_ms_per_chain_addition": horner_op,
                   "vs_horner": ms / chain / (sum(horner_op) / len(horner_op)),
                   "plain_on": "cpu" if plain_cpu else "cuda",
                   **bound(nbytes, products * pf.mont_mul_word_ops(L)),
                   "bound_15bit_ms": digit["bound_ms"], "bound_15bit_by": digit["bound_by"],
                   "card": card_line()}
            emit({"phase": "kernels", **row})
            if label in ("assembly [r, s, rs]", "assembly s"):
                entries[name] = {
                    "name": name, "route": "cuda", "source": "groth16_tpu_torch/csrc/horner.cu",
                    "replaces": "groth16_tpu/curves/point.py:380", **_kline(row),
                    "c": window, "ms_per_chain_op": row["ms_per_chain_op"],
                    "horner_ms_per_chain_addition": horner_op,
                }
    return entries


def _prove_horner_shapes(dpk):
    """(points, lanes, n) of every MSM of a prove: each G1 lane group and
    the G2 MSM (for _horner_kernels)."""
    g1 = [(tuple(x.reshape(x.shape[:-2] + (-1,)) for x in pts), *pts[2].shape[-2:]) for pts in dpk.g1_groups]
    return {"horner_g1": g1, "horner_g2": [(dpk.b_g2_tail, 1, dpk.b_g2_tail[2].shape[-1])]}


def _scan_rows(g, pts, R, npad, rng, device, fill=True):
    """[R, npad, 2*ce] affine rows laid out as the fused MSM path gathers
    them: row r a random permutation of lane r % lanes of `pts`, Fq2
    coordinates tower-major, a random sign bit in bit 31 of each row's
    first word.  With `fill`, every slot holds one of its lane's finite
    points (cycled through) but one in 16, which holds the infinity
    (0, 0), as does the padding: the DummyCircuit's a, b and B queries are
    nearly all infinity (15 finite points in the 9 rows of the 2^20 G1
    scan, 4 in the G2 one), which would leave the scan's arithmetic all
    but unexercised.  Without it, the key's own points, infinities and
    all."""
    import numpy as np
    import torch

    from groth16_tpu_torch.msm.cuda_scan import SIGN_BIT

    lanes, n = g.batch_shape(pts)
    finite = ~g.is_infinity(pts)
    slots = torch.arange(n, device=device)
    if fill:
        src = torch.stack([
            f[slots % f.numel()] if f.numel() else slots
            for f in (torch.nonzero(finite[lane]).reshape(-1) for lane in range(lanes))
        ])
        inf = ~finite.any(dim=-1, keepdim=True) | (slots % 16 == 15)
    else:
        src, inf = slots.expand(lanes, n), ~finite

    def rows_of(coord):  # [*cs, lanes, n] -> [lanes, n, ce]
        coord = torch.gather(coord, -1, src.expand(coord.shape))
        coord = torch.where(inf, torch.zeros_like(coord), coord)
        if g.k.tower_deg > 1:
            coord = coord.movedim(1, 0)
        return coord.reshape(-1, lanes, n).movedim(0, -1)

    em = torch.cat([rows_of(pts[0]), rows_of(pts[1])], dim=-1)
    em = torch.nn.functional.pad(em, (0, 0, 0, npad - n))
    perm = torch.from_numpy(np.argsort(rng.random((R, npad)), axis=1)).to(device)
    rows = em[(torch.arange(R, device=device) % lanes)[:, None], perm]
    sign = torch.from_numpy(rng.integers(0, 2, (R, npad)).astype(np.int32)).to(device)
    rows[..., 0] |= sign * SIGN_BIT
    return rows.contiguous()


def timed_once(fn):
    """(fn(), its CUDA-event time in ms) of one call, no warm-up: for the
    plain scans, whose one run at the prove's depth takes seconds."""
    import torch

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


# lanes up to which the plain versions of Horner and the scalar
# multiplication run on CPU copies of their inputs (plain_run)
PLAIN_CPU_MAX_LANES = 8


def plain_run(fn, args, on_cpu=False):
    """(fn(*args), ms): timed_once on the card, or (on_cpu) on CPU copies
    of the same tensors (a host-clock time; the Horner chains and the
    assembly's scalar multiplications, whose plain versions are hundreds
    of sequential additions of a few lanes: on the card each addition is
    dozens of launches: ~300 s of the script's time), the
    result brought back to the card.  args: tensors or tuples of them."""
    if not on_cpu:
        return timed_once(lambda: fn(*args))
    host = [tuple(x.cpu() for x in a) if isinstance(a, tuple) else a.cpu() for a in args]
    t0 = time.time()
    out = fn(*host)
    ms = (time.time() - t0) * 1e3
    return tuple(x.cuda() for x in out), ms


# S values of the segment sweep of the scans (filled rows, those that leave
# a segment SWEEP_MIN_STEPS steps), beside the chosen one
SCAN_SWEEP = (1, 4, 8, 16, 32, 64, 128)
SWEEP_MIN_STEPS = 8
# steps a segment of the 2^20 prove's sweep (MIN_SEGMENT_STEPS; S = 1024 //
# steps for the scans whose columns leave SMs idle): S = 1 and the chosen 64
PROVE_SEGMENT_STEPS = (1024, 64)


def scan_nbytes(R, steps, C, ce, live):
    """Bytes a suffix scan must move: y of every step (an infinity test
    needs all of it), x of the `live` finite steps, a prefix row of 3 ce
    words a step and the 3 ce-word total of each of the R*C columns."""
    return (R * steps * ce + live * ce + R * steps * 3 * ce + R * C * 3 * ce) * 4


def _scan_specs(c, g1_pts, g2_pts):
    """(name, tag, curve ops, points, TPU kernel) of K2 on `g1_pts` and
    K3 on `g2_pts` (K2 with G2's b3 where G2 lies over Fq)."""
    from groth16_tpu_torch.curves import codec

    return (
        ("suffix_scan_g1", "K2", codec.g1_ops(c), g1_pts, "groth16_tpu/msm/pallas_scan.py:126"),
        ("suffix_scan_g2", "K3", codec.g2_ops(c), g2_pts, "groth16_tpu/msm/pallas_scan.py:352"),
    )


def _scan_kernels(dpk, c, rng, device, sweep=True):
    """K2/K3 against their plain version at the shapes the prove gives
    them, all K steps of each column: the G1 window group with the most
    points, and the G2 MSM (_scan_check).  Returns their kernels-line
    entries."""
    big = max(range(len(dpk.g1_groups)), key=lambda i: dpk.g1_groups[i][2].numel())
    entries = {}
    g2_pts = tuple(x[..., None, :] for x in dpk.b_g2_tail)
    for name, tag, g, pts, replaces in _scan_specs(c, dpk.g1_groups[big], g2_pts):
        row = _scan_check(tag, name, g, pts, c, rng, device, sweep)
        if row["kernel"].startswith("K2 (G2"):
            replaces = "groth16_tpu/msm/pallas_scan.py:126"
        emit({"phase": "kernels", **row})
        entries[name] = {
            "name": name, "route": "cuda", "source": "groth16_tpu_torch/csrc/suffix_scan.cu",
            "replaces": replaces, "rows_steps_chunks": row["rows_steps_chunks"], "segments": row["segments"],
            **_kline(row),
        }
    return entries


def _scan_check(tag, name, g, pts, c, rng, device, sweep=True) -> dict:
    """K2/K3 on the points `pts` ([*coords, lanes, n]) at the rows, steps
    and chunks msm_plan gives that MSM, all K steps of each column, at the
    S the card chooses (`cuda_scan.scan_segments`), against the plain
    version at the same S, timed from the one run that is checked.  Timed
    at S = 1 and at the chosen S, on filled rows and on the key's own
    rows, and, where `sweep`, over SCAN_SWEEP.  -> the row."""
    import torch

    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.msm import cuda_scan
    from groth16_tpu_torch.msm.pippenger import msm_plan

    sbits = c.r.bit_length()
    k = g.k
    D, L = k.tower_deg, k.spec.n_limbs
    if tag == "K3" and D == 1:  # G2 over Fq: K2 with G2's b3
        tag = "K2 (G2's b3)"
    nr = getattr(k, "nr_int", None)
    ce = D * L
    lanes, n = g.batch_shape(pts)
    plan = msm_plan(g, n, lanes, sbits)
    R, K, C = lanes * plan.wg, plan.K, plan.C
    npad = K * C
    pts = tuple(x[..., :npad] for x in pts)
    rows = _scan_rows(g, pts, R, npad, rng, device)
    key_rows = _scan_rows(g, pts, R, npad, rng, device, fill=False)
    S = cuda_scan.scan_segments(R, K, C, device)

    def run(r, seg):
        if D == 1:
            return cuda_scan.suffix_scan_g1_rows(k.spec, g.b3_val, r, K, C, segments=seg)
        return cuda_scan.suffix_scan_g2_rows(k.spec, nr, g.b3_val, r, K, C, segments=seg)

    plain_ops = cuda_point._plain_ops(k.spec, nr)
    got = run(rows, S)
    want, plain_ms = timed_once(lambda: cuda_scan.suffix_scan_plain(plain_ops, g.b3_val, rows, K, C, S))
    got, want = [got[0], *got[1]], [want[0], *want[1]]
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"{tag} {name} on {c.name} at S = {S}: kernel and plain version disagree")
    ms, ms_s1 = time_ms(lambda: run(rows, S)), time_ms(lambda: run(rows, 1))
    key_ms, key_ms_s1 = time_ms(lambda: run(key_rows, S)), time_ms(lambda: run(key_rows, 1))
    # a step whose affine operand is infinity passes the accumulator on
    live, key_live = (int((x[..., ce:] != 0).any(dim=-1).sum()) for x in (rows, key_rows))
    nbytes = scan_nbytes(R, npad, C, ce, live)
    key_bound = point_bound(scan_nbytes(R, npad, C, ce, key_live), key_live, L, D == 2, mixed=True)
    row = {"kernel": f"{tag} {name}", "curve": c.name, "lanes_points": [lanes, n], "rows_steps_chunks": [R, K, C],
           "segments": S, "live": live, "tolerance": 0,
           "max_abs_err": max_abs_err(got, want), "ms": ms, "ms_s1": ms_s1, "plain_ms": plain_ms,
           **point_bound(nbytes, live, L, D == 2, mixed=True),
           "key_rows": {"live": key_live, "ms": key_ms, "ms_s1": key_ms_s1,
                        "bound_ms": key_bound["bound_ms"], "bound_by": key_bound["bound_by"]}}
    if sweep:
        sweep_s = sorted({s for s in SCAN_SWEEP if s * SWEEP_MIN_STEPS <= K} | {S})
        row["sweep_ms"] = {s: time_ms(lambda: run(rows, s), reps=3) for s in sweep_s}
        row["key_rows"]["sweep_ms"] = {s: time_ms(lambda: run(key_rows, s), reps=3) for s in sweep_s}
    row["card"] = card_line()
    return row


# the device name of a prove's kernel from csrc/ (the profiler's demangled
# name: "void (anonymous namespace)::point_add_group_kernel<26, 1, 0>(...)")
PORT_KERNEL = r"void \(anonymous namespace\)::((?:mont_mul|point_add_words|point_add_group|general_add|horner|scalar_mul|suffix_scan)_kernel<[^>]*>)"


def profile_prove(prove) -> dict:
    """Device time of one prove from a torch.profiler trace of the card
    alone: the summed durations of what the card ran (one stream, so
    nothing overlaps) and the kernels that took most of it.  None where
    the trace holds no device events.  The raw trace is read (kineto's
    events): the profiler's own event tree takes minutes for a prove of
    ~10^5 launches (MNT6-298's 2^20 capture scan)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        proof = prove()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    # the port's own kernels of the prove (csrc/), every one
    ours = {}
    for k, (n, us) in by_name.items():
        m = re.match(PORT_KERNEL, k)
        if m:
            ours[m.group(1)] = {"count": n, "ms": us / 1e3}
    return proof, {
        "profiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6 if by_name else None,
        "device_launches": sum(n for n, _ in by_name.values()),
        "top_device_time": [{"name": k[:90], "count": n, "ms": us / 1e3} for k, (n, us) in top],
        "port_kernels": ours,
        "point_add_and_horner_ms": sum(v["ms"] for k, v in ours.items()
                                       if k.startswith(("point_add", "general_add", "horner"))),
    }


def _kline(row):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_published_ms", "bound_published_by")
    return {k: row[k] for k in keys} | {"library_ms": None}


def _check_special_lanes(g, out):
    """Lane 2 is P + (-P): infinity; the other special lanes are finite."""
    inf = g.is_infinity(out)
    if not bool(inf[2]) or bool(inf[1]) or bool(inf[3]):
        raise AssertionError(f"special lanes wrong: infinity flags {inf[:4].tolist()}")


def phase_reference(device, curve=CURVE, fused=(True,)):
    """A 2^6 DummyCircuit of `curve` proved on the card equals the exact
    prover, on each MSM path of `fused` (True: the fused scan, False: the
    capture scan)."""
    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator import setup
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(curve)
    ncon, nvar = (1 << 6) - 2, 1 << 5
    rng = Rng(0x2B6)
    pk, _ = setup(DummyCircuit(nvar, ncon), curve, rng)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(nvar, ncon, a=3, b=5)(cs)
    prover = TorchProver(pk, cs.to_matrices(), device=device)
    want = create_proof_with_reduction(DummyCircuit(nvar, ncon, a=3, b=5), pk, r, s)
    for path in fused:
        with configure(msm_fused_scan=path):
            got = prover.prove(cs.full_assignment(), r, s)
        if not _same(got, want):
            raise AssertionError(f"the 2^6 {curve} proof on the card ({'fused' if path else 'capture'} scan) "
                                 "differs from the exact prover's")
    emit({"phase": "reference", "curve": curve, "circuit": "DummyCircuit 2^6",
          "msm_scans": ["fused" if f else "capture" for f in fused], "equal_to_exact_prover": True})


def zero_counts():
    from groth16_tpu_torch.utils import profiling

    profiling.reset_counts()


def launch_sizes() -> dict:
    """Launches by size class (K1: elements a launch, and those that read
    an operand with a period; K4-K7: points a launch), and the most of one
    launch, of each kernel that launched since zero_counts()."""
    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.fields import cuda_fp

    return {
        k: dict(v, largest=m.LARGEST_LAUNCH[k])
        for m in (cuda_fp, cuda_point)
        for k, v in m.LAUNCH_SIZES.items()
        if m.LARGEST_LAUNCH[k]
    }


def read_counts(kernels) -> dict:
    """Launches per kernel since zero_counts(); raises if one of `kernels`
    never launched or a plain version ran on the card."""
    from groth16_tpu_torch.utils import profiling

    snap = profiling.snapshot()
    launches, plain = snap["launches"], snap["plain"]
    if not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the card: {plain}")
    return launches


MAIN_KERNELS = ("mont_mul", "add_g1", "add_g2", "horner_g1", "horner_g2", "suffix_scan_g1",
                "suffix_scan_g2")
CAPTURE_KERNELS = ("mont_mul", "add_g1", "add_g2", "horner_g1", "horner_g2", "add_mixed_g1",
                   "add_mixed_g2")
SETUP_KERNELS = ("mont_mul", "add_g1", "add_g2")


def phase_main_path(pk, vk, cs, rng, device):
    """The prove at 2^16 through TorchProver (fused MSM scans); returns
    the prover, the launches per kernel of its first prove, and that
    prove's (r, s, proof)."""
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.utils.profiling import PhaseTimer

    c = get_curve(CURVE)
    matrices, z = cs.to_matrices(), cs.full_assignment()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prover = TorchProver(pk, matrices)
    upload_s = time.time() - t0
    if prover.device.type != "cuda":
        raise AssertionError(f"TorchProver's default device is {prover.device}")
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    proofs = [prover.prove(z, r, s)]
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = read_counts(MAIN_KERNELS)
    sizes = launch_sizes()
    first = (r, s, proofs[0])

    t0 = time.time()
    z_enc = prover.encode_assignment(z)
    torch.cuda.synchronize()
    encode_s = time.time() - t0
    timer = PhaseTimer(verbose=False, device="cuda")
    walls = []
    for i in range(3):
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        t0 = time.time()
        proofs.append(prover.prove_encoded_host(z_enc, r, s, timer=timer if i == 2 else None))
        walls.append(time.time() - t0)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    proof, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    proofs.append(proof)
    if prof["device_busy_s"] is not None:
        # both from the one profiled prove
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    pvk = prepare_verifying_key(vk)
    for i, proof in enumerate(proofs):
        if not verify_proof(pvk, proof, [15]):
            raise AssertionError(f"proof {i} does not verify")
        if verify_proof(pvk, proof, [16]):
            raise AssertionError(f"proof {i} verifies with a wrong public input")
    emit({
        "phase": "main_path", "curve": CURVE, "log_n": LOG_N, "msm_scan": "fused",
        "pk_upload_s": upload_s, "first_prove_s": first_s, "assignment_encode_s": encode_s,
        "steady_prove_s": walls, "phases_s": timer.as_dict(), "profile": prof,
        "launches_per_prove": launches, "launches_by_size": sizes,
        "proofs_verified": len(proofs), "wrong_input_rejected": True,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    return prover, launches, first


def phase_capture_path(prover, cs, first):
    """One prove with the capture-scan MSM path (K6/K7 steps); its proof
    must equal the main path's for the same r and s.  K6 and K7 are then
    held against their plain versions at the most points of one of their
    launches in that prove."""
    import torch

    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.utils.profiling import PhaseTimer

    r, s, want = first
    z = cs.full_assignment()
    timer = PhaseTimer(verbose=False, device="cuda")
    with configure(msm_fused_scan=False):
        zero_counts()
        t0 = time.time()
        got, k6_sizes = _recording_k6_sizes(lambda: prover.prove(z, r, s, timer=timer))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(CAPTURE_KERNELS)
        sizes = launch_sizes()
        # a steady one under the profiler: the device time of K6 and K7
        z_enc = prover.encode_assignment(z)
        steady, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    for proof in (got, steady):
        if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
            raise AssertionError("the capture-scan proof differs from the fused-scan proof")
    widest = {k: [sizes[k]["largest"]] for k in ("add_mixed_g1", "add_mixed_g2")}
    src_of = lambda g: _key_points(prover.dpk, g)  # noqa: E731
    _check_adds(src_of, get_curve(CURVE), prover.device, widest)
    emit({
        "phase": "capture_path", "msm_scan": "capture", "prove_s": wall, "phases_s": timer.as_dict(),
        "launches_per_prove": launches, "launches_by_size": sizes, "equal_to_main_path_proof": True,
        "k6_k7_digit_equal_at_n": widest, "k6_launches_by_points": k6_sizes, "profile": prof,
    })
    # K6's two forms at the points of this prove's launches
    _k6_forms(src_of, get_curve(CURVE), prover.device, sizes=list(k6_sizes), check=False, rounds=1)
    return launches


BATCH = 4  # bench.py's batch of 2^16 proofs
BATCH_ROUNDS = 2
ASSEMBLY_KERNELS = ("mont_mul", "add_g1", "add_g2", "scalar_mul_g1", "scalar_mul_g2")


def _verify_all(vk, proofs, what):
    """Every proof verifies with public input 15 and fails with 16."""
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof

    pvk = prepare_verifying_key(vk)
    for i, proof in enumerate(proofs):
        if not verify_proof(pvk, proof, [15]):
            raise AssertionError(f"{what} proof {i} does not verify")
        if verify_proof(pvk, proof, [16]):
            raise AssertionError(f"{what} proof {i} verifies with a wrong public input")


def _same(a, b) -> bool:
    return (a.a, a.b, a.c) == (b.a, b.b, b.c)


def phase_batch(prover, vk, cs, rng):
    """prove_batch of BATCH proofs of the 2^16 assignment with distinct r
    and s (bench.py's batch_prove): the first batch counted (the fused
    path's kernels must launch), then BATCH_ROUNDS rounds of a steady
    single prove (prove_encoded_host, bench.py's single wall), a single
    prove with its encoding (prove) and a batch, in turns, with the peak
    memory over them, then a profiled batch; bench.py's keys from the
    least single and batch walls.  Proofs 0 and BATCH - 1 of the last
    timed batch must equal single proves with the same r and s, and every
    proof verify.  Then one counted batch on the capture path (its proofs
    equal the fused batch's), and on each path a batch dispatched under
    torch.cuda.set_sync_debug_mode("error"): nothing from the first
    dispatch to the fetch may wait for the card."""
    import torch

    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.prover_torch import fetch

    c = get_curve(CURVE)
    z = cs.full_assignment()
    z_enc = prover.encode_assignment(z)

    def draw():
        return [rng.field_element(c.r) for _ in range(BATCH)], [rng.field_element(c.r) for _ in range(BATCH)]

    zero_counts()
    rs, ss = draw()
    t0 = time.time()
    proofs = prover.prove_batch([z] * BATCH, rs, ss)
    first_s = time.time() - t0
    launches = read_counts(MAIN_KERNELS)
    walls = {"single": [], "single_with_encode": [], "batch": []}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(BATCH_ROUNDS):
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        t0 = time.time()
        prover.prove_encoded_host(z_enc, r, s)
        walls["single"].append(time.time() - t0)
        t0 = time.time()
        prover.prove(z, r, s)
        walls["single_with_encode"].append(time.time() - t0)
        rs, ss = draw()
        t0 = time.time()
        timed = prover.prove_batch([z] * BATCH, rs, ss)
        walls["batch"].append(time.time() - t0)
        proofs += timed
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i in (0, BATCH - 1):
        if not _same(timed[i], prover.prove(z, rs[i], ss[i])):
            raise AssertionError(f"batch proof {i} differs from the single prove with its r and s")
    r3, s3 = draw()
    profiled, prof = profile_prove(lambda: prover.prove_batch([z] * BATCH, r3, s3))
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    with configure(msm_fused_scan=False):
        zero_counts()
        t0 = time.time()
        capture = prover.prove_batch([z] * BATCH, rs, ss)
        capture_s = time.time() - t0
        capture_launches = read_counts(CAPTURE_KERNELS)
    if not all(_same(a, b) for a, b in zip(capture, timed)):
        raise AssertionError("the capture-scan batch differs from the fused-scan batch")
    unsynced = {}
    for fused in (True, False):
        with configure(msm_fused_scan=fused):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                accs = prover.dispatch_batch([z] * BATCH)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            fetch([x for acc4, b2 in accs for x in acc4 + b2])
            unsynced["fused" if fused else "capture"] = True
    _verify_all(vk, proofs + profiled + capture, "batch")
    wall, t_batch = min(walls["single"]), min(walls["batch"])
    emit({
        "phase": "batch", "curve": CURVE, "log_n": LOG_N,
        "batch_prove": {"batch": BATCH, "proofs_per_s": BATCH / t_batch, "batch_wall_s": t_batch,
                        "per_proof_vs_single": t_batch / BATCH / wall, "first_call_s": first_s},
        "per_proof_vs_single_with_encode": t_batch / BATCH / min(walls["single_with_encode"]),
        "walls_s_in_turns": walls, "peak_mem_gib": peak, "profile": prof,
        "launches_per_batch": launches, "capture_batch_s": capture_s,
        "capture_launches_per_batch": capture_launches,
        "no_host_sync_from_dispatch_to_fetch": unsynced, "equal_to_single_proves": [0, BATCH - 1],
        "capture_equal_to_fused": True, "proofs_verified": len(proofs) + 2 * BATCH,
        "wrong_input_rejected": True, "card": card_line(),
    })
    return {"batch": launches, "batch_capture": capture_launches}


def _device_assembly(prover, z_enc, r, s):
    """The witness map and MSMs of one prove, then, timed apart, the host
    assembly (`_assemble`: one fetch, the exact engine) and the device
    assembly (`assembly_phase`, counted, then profiled) of the same
    accumulators, and to_affine of the assembly's shapes (2 G1 points, 1
    G2 point) alone, counted and timed.  Returns the numbers and the two
    proofs."""
    import torch

    from groth16_tpu_torch.curves import codec
    from groth16_tpu_torch.fields import cuda_fp
    from groth16_tpu_torch.protocol import prover_torch as pt

    dpk, rr = prover.dpk, prover.c.r
    acc4, b2 = pt.msm_phases(dpk, z_enc)
    torch.cuda.synchronize()
    t0 = time.time()
    host = prover._assemble(acc4, b2, r, s)
    host_s = time.time() - t0
    bits = pt.scalar_bits([r, s, r * s % rr], prover.device)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    out = pt.assembly_phase(dpk, acc4, b2, bits)
    torch.cuda.synchronize()
    device_s = time.time() - t0
    launches = read_counts(ASSEMBLY_KERNELS)
    device = pt.decode_proof_arrays(prover.curve, out)
    _, prof = profile_prove(lambda: pt.assembly_phase(dpk, acc4, b2, bits))
    g1, g2 = codec.g1_ops(prover.c), codec.g2_ops(prover.c)
    to_affine = {}
    for name, g, pts in (("g1_2_points", g1, tuple(x[..., :2] for x in acc4)),
                         ("g2_1_point", g2, tuple(x[..., None] for x in b2))):
        g.to_affine(pts)
        torch.cuda.synchronize()
        before = cuda_fp.LAUNCHES["mont_mul"]
        t0 = time.time()
        g.to_affine(pts)
        torch.cuda.synchronize()
        to_affine[name] = {"s": time.time() - t0, "k1_launches": cuda_fp.LAUNCHES["mont_mul"] - before}
    return {"host_assembly_s": host_s, "device_assembly_s": device_s, "device_assembly_launches": launches,
            "device_assembly_profile": prof, "to_affine": to_affine}, host, device


def phase_device_assembly(prover, vk, cs, rng):
    """The device assembly at 2^16: prove(host_assembly=False), counted
    (the fused path's kernels and the scalar multiplication must launch),
    equal to the host-assembly proof for the same r and s; the assembly
    alone timed and counted beside the host assembly (_device_assembly);
    ProofStream(depth=2) over 4 jobs yields the host-assembly proofs of
    the same r and s in order."""
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.par.batch_pp import ProofStream
    from groth16_tpu_torch.protocol.prover_torch import decode_proof_arrays
    from groth16_tpu_torch.utils.profiling import PhaseTimer

    c = get_curve(CURVE)
    z = cs.full_assignment()
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    dev = prover.prove(z, r, s, host_assembly=False)
    prove_s = time.time() - t0
    launches = read_counts(MAIN_KERNELS + ("scalar_mul_g1", "scalar_mul_g2"))
    if not _same(dev, prover.prove(z, r, s)):
        raise AssertionError("the device-assembled proof differs from the host-assembled one")
    z_enc = prover.encode_assignment(z)
    timer = PhaseTimer(verbose=False, device="cuda")
    r2, s2 = rng.field_element(c.r), rng.field_element(c.r)
    timed = prover.prove_encoded(z_enc, r2, s2, timer=timer)
    nums, host, assembled = _device_assembly(prover, z_enc, r2, s2)
    if not (_same(host, assembled) and _same(assembled, decode_proof_arrays(CURVE, timed))):
        raise AssertionError("the device assembly differs from the host assembly")
    jobs = [(z, rng.field_element(c.r), rng.field_element(c.r)) for _ in range(4)]
    want = prover.prove_batch([z] * 4, [j[1] for j in jobs], [j[2] for j in jobs])
    torch.cuda.synchronize()
    t0 = time.time()
    streamed = list(ProofStream(prover, depth=2).prove_all(jobs))
    stream_s = time.time() - t0
    if not all(_same(a, b) for a, b in zip(streamed, want)) or len(streamed) != 4:
        raise AssertionError("ProofStream's proofs differ from the host-assembly proofs of the same r and s")
    _verify_all(vk, [dev, assembled] + streamed, "device-assembly")
    emit({
        "phase": "device_assembly", "curve": CURVE, "log_n": LOG_N, "prove_s": prove_s,
        "launches_per_prove": launches, "equal_to_host_assembly": True, "phases_s": timer.as_dict(),
        **nums, "proof_stream": {"depth": 2, "jobs": 4, "wall_s": stream_s, "proofs_per_s": 4 / stream_s,
                                 "in_order_equal_to_host_assembly": True},
        "card": card_line(),
    })
    return {"device_assembly": launches}


MULTI_KERNELS = MAIN_KERNELS + ("scalar_mul_g1", "scalar_mul_g2")  # the sharded prove assembles on the card
MULTI_BATCH = 4
MULTI_TIMEOUT_S = 400  # a launch of ranks is ended after this; on one H100 they take 14-25 s


def _multi_rank_line(o) -> dict:
    """A rank's figures from par.dryrun.rank_prove, for the phase's line."""
    if any(o["plain"].values()):
        raise AssertionError(f"a plain version ran on the card in a sharded rank: {o['plain']}")
    if not all(o["launches"][k] > 0 for k in MULTI_KERNELS):
        raise AssertionError(f"a kernel of the sharded path never launched: {o['launches']}")
    if not o["steady_equal"]:
        raise AssertionError("a sharded rank's second proof differs from its first")
    return {
        "rank": o["rank"], "index": o["index"], "key_shard": o["key_shard"], "upload_s": o["upload_s"],
        "first_prove_s": o["first_prove_s"], "steady_prove_s": o["steady_prove_s"], "phases_s": o["phases_s"],
        "launches": {k: v for k, v in o["launches"].items() if v}, "collective_traffic": o["traffic"],
        "peak_mem_gib": o["peak_mem_bytes"] and o["peak_mem_bytes"] / 2**30,
    }


def _sharded_kernels(pk, matrices, device, S=2):
    """The kernels at the shapes the sharded prove on S ranks gives them
    (rank 0's; every rank's are the same), each against its plain version
    on the same inputs and timed beside its bound: K1 at the four-step
    NTT's twiddle tile ([L, n2/S, n1] against the rank's w^(j2 k1) table),
    at its first length-n1 stage (n/(2S) elements against the stage's
    twiddle row, read with its period) and at the coset scale of
    coset_ifft (against the rank's slice of its power table); K2 and K3
    on rank 0's key shard (the 4-lane stack of n_pad/S points, the G2
    tail's slice) at the rows, steps and chunks msm_plan picks for them.
    -> the kernels line's rows at these shapes (K1's: the twiddle
    tile's), by kernel name."""
    import numpy as np

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.ntt.ntt import NttDomain, _stage_tws
    from groth16_tpu_torch.par.ntt_cp import _power_slice, _twiddles
    from groth16_tpu_torch.protocol.device_keys import upload_proving_key

    c = get_curve(CURVE)
    rng = np.random.default_rng(0x5A4D)
    domain = NttDomain(c.fr, matrices.num_constraints + matrices.num_instance_variables, device)
    spec, n, r = domain.spec, domain.size, c.r
    n1 = 1 << ((domain.log_size + 1) // 2)
    n2, m = n // n1, n // S
    shapes = (
        ("twiddle tile", _twiddles(spec, domain.group_gen, n1, n2, S, 0, device).reshape(spec.n_limbs, m), m),
        ("first n1-stage", _stage_tws(spec, pow(domain.group_gen, n2, r), n1, device)[0], m // 2),
        ("coset scale", _power_slice(spec, pow(c.fr.generator, r - 2, r), 0, m, domain.size_inv, device), m),
    )
    out = {}
    for what, b, k1_n in shapes:
        h = b.shape[-1] if b.shape[-1] < k1_n else None
        row = {"kernel": f"K1 mont_mul (sharded NTT, S = {S}: {what})", "field": "bn254.Fr", "n": k1_n,
               "period": h, **_k1_row(spec, _lazy_operand(rng, spec, k1_n, device), b, k1_n, h, sweep=False)}
        emit({"phase": "kernels", **row})
        out.setdefault("mont_mul", {"n": k1_n, "period": h, **_kline(row)})
    dpk = upload_proving_key(pk, matrices, device, shard=(0, S))
    for name, tag, g, pts, _ in _scan_specs(c, dpk.g1_msm_points, tuple(x[..., None, :] for x in dpk.b_g2_tail)):
        row = _scan_check(tag, name, g, pts, c, rng, device, sweep=False)
        row["kernel"] += f" (sharded MSM, rank 0 of {S})"
        emit({"phase": "kernels", **row})
        out[name] = {k: row[k] for k in ("lanes_points", "rows_steps_chunks", "segments")} | _kline(row)
    return out


def phase_multi_device(pk, vk, cs, prover, first):
    """The sharded path on the 2^16 key: the kernels at its shapes
    (_sharded_kernels), then world size 1 over NCCL, 2 ranks on one card
    over gloo (see the module docstring).  Returns the launches per
    kernel of each sharded prove (the NCCL rank's; the two gloo ranks'
    summed) and _sharded_kernels' rows."""
    import random

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.par import dryrun as dr
    from groth16_tpu_torch.par.mesh import DATA_AXIS, run_ranks
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof

    r, s, want = first
    matrices, z = cs.to_matrices(), cs.full_assignment()
    rows = _sharded_kernels(pk, matrices, prover.device)
    args = (pk, matrices, z, r, s)
    pvk = prepare_verifying_key(vk)

    def same(proof, what):
        if not _same(proof, want):
            raise AssertionError(f"{what}: the sharded proof differs from the single-device proof")
        if not verify_proof(pvk, proof, [15]):
            raise AssertionError(f"{what}: the sharded proof does not verify")

    t0 = time.time()
    (one,) = run_ranks(dr.rank_prove, 1, "nccl", "cuda", *args, None, DATA_AXIS, True, timeout_s=MULTI_TIMEOUT_S)
    nccl_s = time.time() - t0
    same(one["proof"], "world size 1 over nccl")

    c_r = get_curve(CURVE).r
    rnd = random.Random(0x5BA7)
    coeffs = [rnd.randrange(c_r) for _ in range(1 << LOG_N)]
    rs = [rnd.randrange(c_r) for _ in range(MULTI_BATCH)]
    ss = [rnd.randrange(c_r) for _ in range(MULTI_BATCH)]
    scenarios = [
        (dr.InjectedFault("loss", (0,)), 3, False),
        (dr.InjectedFault("sdc", (0,)), 3, False),
        (None, 3, True),
    ]
    calls = [
        (dr.rank_prove, args + (None, DATA_AXIS, True)),
        (dr.rank_ntt, (CURVE, coeffs, 5)),
        (dr.rank_key_msm, (pk, matrices, z)),
        (dr.rank_elastic, args + (scenarios,)),
        (dr.rank_batch, (pk, matrices, [z] * MULTI_BATCH, rs, ss)),
    ]
    t0 = time.time()
    ranks = run_ranks(dr.rank_calls, 2, "gloo", "cuda", calls, timeout_s=MULTI_TIMEOUT_S)
    gloo_s = time.time() - t0
    n_pad = -(-max(len(pk.h_query), len(pk.l_query), len(pk.a_query) - 1) // 2) * 2
    for i, (prove, ntt, key_msm, elastic, batch) in enumerate(ranks):
        same(prove["proof"], f"rank {i} of 2 over gloo")
        if prove["key_shard"]["g1_points"] != 4 * n_pad // 2:
            raise AssertionError(f"rank {i} holds {prove['key_shard']} of a 4 x {n_pad} stack")
        if not all(ntt["equal_single"].values()):
            raise AssertionError(f"rank {i}: ShardedNtt differs from NttDomain: {ntt['equal_single']}")
        if not key_msm["equal_affine"]:
            raise AssertionError(f"rank {i}: msm_sharded_lanes differs from msm_device_lanes")
        loss, sdc, healthy = elastic
        for name, e in (("loss", loss), ("sdc", sdc), ("healthy", healthy)):
            same(e["proof"], f"rank {i}: elastic {name}")
        if [a.n_devices for a in loss["report"].attempts] != [2, 1] or loss["n_devices"] != 1:
            raise AssertionError(f"rank {i}: the device loss did not shrink to one rank: {loss['report']}")
        if [a.ok for a in sdc["report"].attempts] != [False, True]:
            raise AssertionError(f"rank {i}: the SDC was not retried: {sdc['report']}")
        if healthy["faults"] != [] or healthy["report"].retried:
            raise AssertionError(f"rank {i}: the healthy run found faults: {healthy}")
    batch = ranks[0][4]
    if ranks[1][4] != batch:
        raise AssertionError("the ranks' prove_batch_sharded proofs differ")
    single = prover.prove_batch([z] * MULTI_BATCH, rs, ss)
    if any(not _same(a, b) for a, b in zip(batch, single)):
        raise AssertionError("prove_batch_sharded differs from prove_batch on one rank")
    t0 = time.time()
    dry = dr.dryrun_multichip(2, device="cuda", backend="gloo")
    dry_s = time.time() - t0
    gloo = [_multi_rank_line(rk[0]) for rk in ranks]
    emit({
        "phase": "multi_device", "curve": CURVE, "log_n": LOG_N, "card": card_line(),
        "nccl_world_1": dict(_multi_rank_line(one), wall_s=nccl_s),
        "gloo_2_ranks_one_card": {"wall_s": gloo_s, "ranks": gloo},
        "sharded_ntt_2p16": {"equal": True, "sharded_fft_ms": [rk[1]["sharded_fft_ms"] for rk in ranks],
                             "single_fft_ms": [rk[1]["single_fft_ms"] for rk in ranks]},
        "key_msm_equal_affine": {"lanes": ranks[0][2]["lanes"], "points_per_rank": ranks[0][2]["points_per_rank"]},
        "elastic": {"loss_attempts": [a.n_devices for a in ranks[0][3][0]["report"].attempts],
                    "sdc_attempts": [a.error for a in ranks[0][3][1]["report"].attempts], "faults": []},
        "batch_sharded_equal_prove_batch": MULTI_BATCH, "dryrun_multichip_2_s": dry_s,
        "dryrun_proof_verified": dry is not None,
    })
    summed = {k: sum(rk[0]["launches"][k] for rk in ranks) for k in ranks[0][0]["launches"]}
    return {"multi_device": one["launches"], "multi_device_gloo2": summed}, rows


def phase_device_setup(pk_exact):
    """setup_device of the 2^16 bn254 circuit with the exact setup's seed:
    the same key, through K1, K4 and K5."""
    import torch

    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.utils.profiling import PhaseTimer
    from groth16_tpu_torch.utils.rng import Rng

    n_constraints, n_vars = (1 << LOG_N) - 2, 1 << (LOG_N - 1)
    timer = PhaseTimer(verbose=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    pk, _ = setup_device(DummyCircuit(n_vars, n_constraints), CURVE, Rng(0xBE7C), timer=timer)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts(SETUP_KERNELS)
    sizes = launch_sizes()
    if pk != pk_exact:
        raise AssertionError("the device setup's key differs from the exact setup's")
    emit({
        "phase": "device_setup", "curve": CURVE, "log_n": LOG_N, "setup_s": wall,
        "phases_s": timer.as_dict(), "launches": launches, "launches_by_size": sizes,
        "equal_to_exact_setup": True,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    })
    return launches


def _check_sampled(curve, pk, record, k=64, seed=0x5A):
    """k points of each query (half of them, where there are that many,
    from nonzero scalars) recomputed on the host as scalar x generator
    with the exact engine (its Jacobian fixed-base batch_mul, one window
    table a generator), from the scalars the device built."""
    import numpy as np
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields.spec import decode, make_spec
    from groth16_tpu_torch.ref.group import g1_jacobian, g2_jacobian

    c = get_curve(curve)
    spec = make_spec(c.r)
    rng = np.random.default_rng(seed)
    na, nb, nh, nl, ni = record["counts"]
    queries = (
        ("a_query", "g1", 0, na, pk.a_query),
        ("b_g1_query", "g1", na, nb, pk.b_g1_query),
        ("h_query", "g1", na + nb, nh, pk.h_query),
        ("l_query", "g1", na + nb + nh, nl, pk.l_query),
        ("gamma_abc_g1", "g1", na + nb + nh + nl, ni, pk.vk.gamma_abc_g1),
        ("b_g2_query", "g2", 0, nb, pk.b_g2_query),
    )
    picked = {"g1": [], "g2": []}
    for name, grp, off, n, pts in queries:
        scal = record[grp]
        nonzero = torch.nonzero((scal[:, off : off + n] != 0).any(dim=0)).reshape(-1).cpu().numpy()
        pick = set(rng.choice(nonzero, size=min(k // 2, len(nonzero)), replace=False).tolist())
        rest = rng.permutation(n)
        pick |= set(rest[: max(0, min(k, n) - len(pick))].tolist())
        idx = sorted(pick)
        vals = decode(scal[:, [off + i for i in idx]].cpu().numpy(), spec, mont=False)
        picked[grp] += [(name, i, s, pts[i]) for i, s in zip(idx, vals)]
    checked = dict.fromkeys((q[0] for q in queries), 0)
    for grp, ops in (("g1", g1_jacobian(c)), ("g2", g2_jacobian(c))):
        want = ops.batch_mul(record[f"{grp}_generator"], [s for _, _, s, _ in picked[grp]], c.r.bit_length())
        for (name, i, _, got), w in zip(picked[grp], want):
            if got != w:
                raise AssertionError(f"{name}[{i}] is not its scalar times the generator")
            checked[name] += 1
    return checked


def _step(out: dict, name: str):
    """Emit the fields `out` gained since the last step of its phase."""
    seen = out.setdefault("_seen", set())
    new = {k: v for k, v in out.items() if k not in seen and k != "_seen"}
    seen.update(new)
    emit({"phase": out["phase"], "step": name, **new})


def phase_bls377(device):
    """bls12_377 (Fq2 nonresidue -5) at 2^16: the bench's line with a
    fresh setup on the card (groth16_tpu_torch.bench.run, its verifier on
    the native engine), 64 points of each query of its key checked on the
    host, K1 at bls12_377's p and r, K4-K7, the Horner kernels, K2/K3 and
    the scalar multiplication on its key's points against their plain
    versions (NR = -5 in K3, K5, K7, Horner G2 and the G2 scalar
    multiplication), then one fused prove, counted (K1-K5 and the Horner
    kernels must launch, no plain version on the card), a capture-scan
    prove with the same r and s, counted (K6, K7), and a device-assembled
    one (the scalar multiplication), both equal to the fused proof; every
    proof verifies with public input 15 and fails with 16, and one is
    timed on the native and on the Python verifier engine; a steady
    prove under torch.profiler; a 2^6 proof equals the exact prover's on
    both MSM paths.  Returns the launches by path, the kernel rows and
    K3's (rows, steps, chunks, S)."""
    import numpy as np
    import torch

    from groth16_tpu_torch.bench import run
    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(B377_CURVE)
    out = {"phase": "bls12_377", "curve": B377_CURVE, "log_n": B377_LOG_N, "fq2_nonresidue": c.fp2_nonresidue}
    keep = {}
    out["bench"] = run(B377_CURVE, B377_LOG_N, device=device, keep=keep)
    if out["bench"]["extras"]["verify_engine"] != "native":
        raise AssertionError("the bls12_377 bench did not verify on the native engine")
    _step(out, "bench")
    pk, prover, z = keep["pk"], keep["prover"], keep["z"]
    t0 = time.time()
    out["sampled_points_checked"] = _check_sampled(B377_CURVE, pk, keep.pop("record"))
    out["sampled_check_s"] = time.time() - t0
    _step(out, "key")
    krng = np.random.default_rng(0x377)
    src_of = lambda g: _key_points(prover.dpk, g)  # noqa: E731
    rows = {"mont_mul": _mont_mul_kernel(krng, device, K1_SIZES_377),
            **_point_kernels(prover.dpk, c, N_KERNEL, device, mixed=(False, True)),
            **_horner_kernels(_prove_horner_shapes(prover.dpk), c, device),
            **_scan_kernels(prover.dpk, c, krng, device)}
    rows.update(_scalar_mul_kernels(src_of, c, device, rows, 0x5CA3, extra_lanes=()))
    scan = rows["suffix_scan_g2"]
    k3_shape = (*scan["rows_steps_chunks"], scan["segments"])
    rng = Rng(0x377)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    fused = prover.prove(z, r, s)
    torch.cuda.synchronize()
    out["prove_s"] = time.time() - t0
    launches = read_counts(MAIN_KERNELS)
    out["launches_per_prove"] = launches
    out["launches_by_size"] = launch_sizes()
    with configure(msm_fused_scan=False):
        zero_counts()
        capture = prover.prove(z, r, s)
        capture_launches = read_counts(CAPTURE_KERNELS)
    zero_counts()
    assembled = prover.prove(z, r, s, host_assembly=False)
    assembly = read_counts(MAIN_KERNELS + ("scalar_mul_g1", "scalar_mul_g2"))
    if not (_same(capture, fused) and _same(assembled, fused)):
        raise AssertionError("the bls12_377 capture-scan or device-assembled proof differs from the fused one")
    _verify_all(keep["vk"], [fused, capture, assembled], "bls12_377")
    out["verify_s"] = _verify_engines(keep["vk"], fused)
    z_enc = prover.encode_assignment(z)
    _, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    out.update(capture_launches_per_prove=capture_launches, device_assembly_launches_per_prove=assembly,
               capture_and_device_assembly_equal_to_fused=True, proofs_verified=3, wrong_input_rejected=True,
               profile=prof, card=card_line())
    _step(out, "prove")
    del keep, prover, pk
    phase_reference(device, B377_CURVE, fused=(True, False))
    return ({"bls12_377": launches, "bls12_377_capture": capture_launches,
             "bls12_377_device_assembly": assembly}, rows, k3_shape)


# BW6-761 (L = 52): G1 and G2 both lie over Fq, so every G2 addition,
# scan step and Horner chain runs G1's kernels (K4, K6, K2, Horner) with
# G2's b3, and the kernels over Fq2 never launch
BW6_FQ2_KERNELS = ("add_g2", "add_mixed_g2", "horner_g2", "suffix_scan_g2", "scalar_mul_g2")
BW6_MAIN = ("mont_mul", "add_g1", "horner_g1", "suffix_scan_g1")
BW6_CAPTURE = ("mont_mul", "add_g1", "horner_g1", "add_mixed_g1")
BW6_ASSEMBLY = BW6_MAIN + ("scalar_mul_g1",)
# BW6-761's G2 rows of the kernel checks, by the G1 kernel that runs them
BW6_G2_ROWS = {"add_g2": "add_g1", "add_mixed_g2": "add_mixed_g1", "horner_g2": "horner_g1",
               "suffix_scan_g2": "suffix_scan_g1", "scalar_mul_g2": "scalar_mul_g1"}


def _bw6_counts(kernels, what):
    """read_counts(kernels), K1's launches at each L, and a check that no
    kernel over Fq2 launched."""
    from groth16_tpu_torch.fields import cuda_fp

    launches = read_counts(kernels)
    ran = {k: launches[k] for k in BW6_FQ2_KERNELS if launches[k]}
    if ran:
        raise AssertionError(f"bw6_761 {what}: a kernel over Fq2 launched: {ran}")
    by_l = {k: v for k, v in cuda_fp.LAUNCH_SIZES["mont_mul"].items() if k.startswith("L")}
    return dict(launches, mont_mul_by_limbs=by_l)


def _gadget_circuit(device, inner, counts):
    """The gadget circuit (r1cs/gadget_circuit.py: G1AddCircuit, a G1
    addition of the inner curve in-circuit, its x public) set up on the
    card with the cycle's outer curve (BW6-761 for BLS12-377, MNT6-298 for
    MNT4-298) and proved by TorchProver (counted: counts(what) reads and
    checks the launches); the proof must equal the exact prover's on the
    same key, r and s, verify with the sum's x and fail with x + 1."""
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.gadget_circuit import CYCLES, G1AddCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.ref.curve import RefGroups
    from groth16_tpu_torch.utils.rng import Rng

    outer = CYCLES[inner]
    c = get_curve(outer)
    groups = RefGroups(inner)
    P = groups.g1_sample(3)
    Q = groups.g1_mul(P, 0xC0FFEE)
    x = groups.g1_add(P, Q)[0]
    rng = Rng(0x6AD)
    t0 = time.time()
    pk, vk = setup_device(G1AddCircuit(inner=inner), outer, rng, device=device)
    setup_s = time.time() - t0
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    G1AddCircuit(P, Q, inner=inner)(cs)
    if not cs.is_satisfied() or cs.full_assignment()[1] != x:
        raise AssertionError(f"the {inner} gadget circuit's assignment is wrong")
    prover = TorchProver(pk, cs.to_matrices(), device=device)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    proof = prover.prove(cs.full_assignment(), r, s)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    launches = counts(f"{inner} gadget circuit")
    if not _same(proof, create_proof_with_reduction(G1AddCircuit(P, Q, inner=inner), pk, r, s)):
        raise AssertionError(f"the {inner} gadget circuit's proof on the card differs from the exact prover's")
    pvk = prepare_verifying_key(vk)
    if not verify_proof(pvk, proof, [x]) or verify_proof(pvk, proof, [(x + 1) % c.r]):
        raise AssertionError(f"the {inner} gadget circuit's proof does not verify, or verifies a wrong input")
    return {"circuit": f"G1AddCircuit (a {inner} G1 addition in-circuit over {outer}'s r, its x public)",
            "constraints": cs.num_constraints, "setup_s": setup_s, "prove_s": prove_s,
            "launches": launches, "equal_to_exact_prover": True, "verified": True,
            "wrong_input_rejected": True}


def phase_bw6(device):
    """BW6-761 at 2^16 (L = 52 for its 761-bit Fq, G2 over Fq): the
    port's bench with a fresh setup on the card (its line printed,
    verified on the native engine; K1's launches at L = 52 are the
    setup's decode), 64 points of each query of its key checked on the
    host, K1 at its p (with a period and a constant operand) and r, K4
    and K6 (its one form at L = 52) with G1's and with G2's b3, Horner and K2 at the
    prove's shapes and the card's S, and the scalar multiplication at
    the device assembly's shapes, on its key's points against their plain
    versions; then a fused prove (counted: K1, K2, K4 and Horner launch,
    nothing over Fq2, no plain version on the card), a capture-scan prove
    (K6) and a device-assembled one (the scalar multiplication, and K1 at
    L = 52 in its to_affine), equal, verified with 15 and rejected with
    16; a profiled steady prove; a 2^6 proof equal to the exact prover's
    on both scans; the gadget circuit proved on the card.  Returns the
    launches by path and the kernel rows (G2's beside G1's)."""
    import numpy as np
    import torch

    from groth16_tpu_torch.bench import run
    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields.spec import make_spec
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(BW6_CURVE)
    out = {"phase": "bw6_761", "curve": BW6_CURVE, "log_n": BW6_LOG_N, "fq_limbs": make_spec(c.p).n_limbs,
           "fr_limbs": make_spec(c.r).n_limbs, "g2_over_fq": c.g2_over_base}
    keep = {}
    zero_counts()
    out["bench"] = run(BW6_CURVE, BW6_LOG_N, device=device, keep=keep)
    out["bench_launches"] = _bw6_counts(BW6_MAIN, "bench")
    if out["bench_launches"]["mont_mul_by_limbs"]["L52"] == 0:
        raise AssertionError("the bw6_761 setup's decode ran no K1 at L = 52")
    if out["bench"]["extras"]["verify_engine"] != "native":
        raise AssertionError("the bw6_761 bench did not verify on the native engine")
    _step(out, "bench")
    pk, prover, z = keep["pk"], keep["prover"], keep["z"]
    t0 = time.time()
    out["sampled_points_checked"] = _check_sampled(BW6_CURVE, pk, keep.pop("record"))
    out["sampled_check_s"] = time.time() - t0
    _step(out, "key")
    krng = np.random.default_rng(0xB6)
    src_of = lambda g: _key_points(prover.dpk, g)  # noqa: E731
    rows = {"mont_mul": _mont_mul_kernel(krng, device, K1_SIZES_BW6),
            **_point_kernels(prover.dpk, c, N_KERNEL, device, mixed=(False, True)),
            **_horner_kernels(_prove_horner_shapes(prover.dpk), c, device),
            **_scan_kernels(prover.dpk, c, krng, device)}
    rows.update(_scalar_mul_kernels(src_of, c, device, rows, 0x5CA6, extra_lanes=()))
    rng = Rng(0xB76)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    fused = prover.prove(z, r, s)
    torch.cuda.synchronize()
    out["prove_s"] = time.time() - t0
    out["launches_per_prove"] = launches = _bw6_counts(BW6_MAIN, "fused prove")
    out["launches_by_size"] = launch_sizes()
    with configure(msm_fused_scan=False):
        zero_counts()
        capture, k6_sizes = _recording_k6_sizes(lambda: prover.prove(z, r, s))
        capture_launches = _bw6_counts(BW6_CAPTURE, "capture prove")
    zero_counts()
    assembled = prover.prove(z, r, s, host_assembly=False)
    assembly = _bw6_counts(BW6_ASSEMBLY, "device-assembled prove")
    if assembly["mont_mul_by_limbs"]["L52"] == 0:
        raise AssertionError("the bw6_761 device assembly ran no K1 at L = 52")
    if not (_same(capture, fused) and _same(assembled, fused)):
        raise AssertionError("the bw6_761 capture-scan or device-assembled proof differs from the fused one")
    _verify_all(keep["vk"], [fused, capture, assembled], "bw6_761")
    out["verify_s"] = _verify_engines(keep["vk"], fused)
    z_enc = prover.encode_assignment(z)
    _, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    out.update(capture_launches_per_prove=capture_launches, k6_launches_by_points=k6_sizes,
               device_assembly_launches_per_prove=assembly, capture_and_device_assembly_equal_to_fused=True,
               proofs_verified=3, wrong_input_rejected=True, profile=prof, card=card_line())
    _step(out, "prove")
    del keep, prover, pk
    phase_reference(device, BW6_CURVE, fused=(True, False))
    out["gadget_circuit"] = _gadget_circuit(device, "bls12_377", lambda what: _bw6_counts(BW6_MAIN, what))
    _step(out, "gadget_circuit")
    # G2's rows beside G1's: they ran G1's kernels with G2's b3
    for g2_name, g1_name in BW6_G2_ROWS.items():
        if g2_name in rows:
            rows[g1_name] = dict(rows[g1_name], g2_b3=rows.pop(g2_name))
    return ({"bw6_761": launches, "bw6_761_capture": capture_launches,
             "bw6_761_device_assembly": assembly}, rows)


# MNT4-298 and MNT6-298 (a = 2 and 11; L = 21 for their 298-bit fields):
# the generic-a full additions (over Fq, over MNT4's Fq2 with NR = 17 and
# over MNT6's Fq3) and K1 at L = 21 carry the prove; the JAX package runs
# no scan kernel and no mixed addition there, so neither may launch
MNT4_CURVE, MNT4_LOG_N = "mnt4_298", 16
MNT6_CURVE, MNT6_LOG_N = "mnt6_298", 20
MNT_MAIN = ("mont_mul", "add_g1", "add_g2", "horner_g1", "horner_g2", "capture_step_g1", "capture_step_g2")
MNT_ASSEMBLY = MNT_MAIN + ("scalar_mul_g1", "scalar_mul_g2")
MNT_A0_KERNELS = ("add_mixed_g1", "add_mixed_g2", "suffix_scan_g1", "suffix_scan_g2")
# K1 at L = 21: MNT4-298's p (= MNT6-298's r) and MNT6-298's p (= MNT4-298's
# r) at 2^16 and 2^20 elements, against a 2^9 period and a constant
K1_SIZES_MNT = (
    ("mnt6_298.Fq", 16, None), ("mnt6_298.Fq", 20, None), ("mnt4_298.Fq", 16, None),
    ("mnt4_298.Fq", 20, None), ("mnt4_298.Fq", 20, 1 << 9), ("mnt4_298.Fq", 16, 1),
)
# points a launch at which the generic-a group kernel is held against its
# plain version beside the 2^16 of _point_kernels
MNT_ADD_CHECK_N = (1, 3, 33, 4096 + 5)


def _mnt_counts(kernels, what, g2_deg, kinds=("add", "capture_step")):
    """read_counts(kernels) with K1's launches at each L and the generic-a
    launches by kernel and field degree; raises if K1 ran nothing at
    L = 21, if the generic-a full addition or its capture step (each of
    `kinds`) did not launch over Fq and over G2's field, if any full
    addition or capture step ran another law, or if a kernel of the
    a = 0 law (K2, K3, K6, K7) launched."""
    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.fields import cuda_fp

    launches = read_counts(kernels)
    ran = {k: launches[k] for k in MNT_A0_KERNELS if launches[k]}
    if ran:
        raise AssertionError(f"{what}: a kernel of the a = 0 law launched: {ran}")
    by_l = {k: v for k, v in cuda_fp.LAUNCH_SIZES["mont_mul"].items() if k.startswith("L")}
    if by_l["L21"] == 0:
        raise AssertionError(f"{what}: no K1 launch at L = 21")
    general = {k: v for k, v in cuda_point.GENERAL_A_LAUNCHES.items() if v}
    for kind in kinds:
        g1, g2 = f"{kind}_g1", f"{kind}_g2"
        n = general.get(f"{kind}_d1", 0) + general.get(f"{kind}_d{g2_deg}", 0)
        if not (general.get(f"{kind}_d1") and general.get(f"{kind}_d{g2_deg}")) or n != launches[g1] + launches[g2]:
            raise AssertionError(f"{what}: the generic-a kernel did not carry every {kind}: {general}")
    return dict(launches, mont_mul_by_limbs=by_l, general_a=general)


def _mnt_kernels(dpk, c, device, seed, widest):
    """The generic-a group kernel of curve c over G1's Fq and G2's Fq2 or
    Fq3 on its key's points against the plain version, at MNT_ADD_CHECK_N
    points and at N_KERNEL (timed; with the infinity, P + P and P + (-P)
    lanes), its capture step at the prove's widest step (`widest`, by
    kernel) and at N_KERNEL, Horner at the prove's MSM shapes and the
    scalar multiplication at the device assembly's, each timed beside its
    bound."""
    src_of = lambda g: _key_points(dpk, g)  # noqa: E731
    _check_adds(src_of, c, device, {"add_g1": MNT_ADD_CHECK_N, "add_g2": MNT_ADD_CHECK_N})
    rows = {**_point_kernels(dpk, c, N_KERNEL, device, mixed=(False,)),
            **_capture_step_kernels(dpk, c, device, {k: (v, N_KERNEL) for k, v in widest.items()}),
            **_horner_kernels(_prove_horner_shapes(dpk), c, device)}
    rows.update(_scalar_mul_kernels(src_of, c, device, rows, seed, extra_lanes=()))
    return rows


def _mnt_fft_check(domain, device, seed, points=4):
    """The fft (mixed-radix or radix-2) at the prove's domain size
    against a direct evaluation (Python ints) of the polynomial (62-bit
    coefficients) at `points` sampled domain points, and ifft(fft(a)) ==
    a (on the card, after reduction to [0, p))."""
    import numpy as np
    import torch

    from groth16_tpu_torch.fields import fp
    from groth16_tpu_torch.fields.spec import decode, encode

    rng = np.random.default_rng(seed)
    p, n = domain.field.modulus, domain.size
    coeffs = [int(x) for x in rng.integers(0, 1 << 62, n)]
    a = torch.from_numpy(encode(coeffs, domain.spec).astype(np.int32)).to(device)
    t0 = time.time()
    ev = domain.fft(a)
    back = domain.ifft(ev)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    idx = sorted(int(i) for i in rng.choice(n, size=points, replace=False))
    got = decode(ev[:, idx].cpu().numpy(), domain.spec)
    for i, v in zip(idx, got):
        x, acc = pow(domain.group_gen, i, p), 0
        for cf in reversed(coeffs):
            acc = (acc * x + cf) % p
        if acc != v:
            raise AssertionError(f"the fft of size {n} differs from the polynomial at w^{i}")
    if not torch.equal(fp.normalize(domain.spec, back, bound_k=2), a):
        raise AssertionError(f"ifft(fft(a)) != a on the domain of size {n}")
    return {"size": n, "radixes": list(domain.radixes), "points_checked": idx, "fft_and_ifft_s": card_s,
            "ifft_of_fft_equal": True}


def _phase_mnt(device, curve, log_n, seed):
    """One MNT curve at 2^log_n: the port's bench with a fresh setup on
    the card (its line printed, verified on the native engine), 64 points
    of each query of its key checked on the host, the generic-a kernels
    on its key (_mnt_kernels), one counted prove (K1 at L = 21 and the
    generic-a additions launch; no K2, K3, K6 or K7; no plain version on
    the card), a device-assembled prove with the same r and s (the
    scalar multiplication; the same proof), both verified with 15 and
    rejected with 16, a steady prove under torch.profiler, a 2^6 proof
    equal to the exact prover's.  Returns (launches by path, rows)."""
    import torch

    from groth16_tpu_torch.bench import run
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(curve)
    g2_deg = c.g2_field_degree
    out = {"phase": curve, "curve": curve, "log_n": log_n, "a": c.a, "g2_field_degree": g2_deg,
           "nonresidue": c.fp2_nonresidue}
    keep = {}
    zero_counts()
    out["bench"] = run(curve, log_n, device=device, keep=keep)
    out["bench_launches"] = _mnt_counts(MNT_MAIN, f"{curve} bench", g2_deg)
    if out["bench"]["extras"]["verify_engine"] != "native":
        raise AssertionError(f"the {curve} bench did not verify on the native engine")
    _step(out, "bench")
    pk, prover, z = keep["pk"], keep["prover"], keep["z"]
    out["setup_phases_s"] = keep["setup_phases_s"]
    out["domain"] = {"size": prover.dpk.domain.size, "radixes": list(prover.dpk.domain.radixes)}
    t0 = time.time()
    out["sampled_points_checked"] = _check_sampled(curve, pk, keep.pop("record"))
    out["sampled_check_s"] = time.time() - t0
    _step(out, "key")
    from groth16_tpu_torch.curves import cuda_point

    widest = {k: cuda_point.LARGEST_LAUNCH[k] for k in ("capture_step_g1", "capture_step_g2")}
    out["widest_capture_step"] = widest
    rows = _mnt_kernels(prover.dpk, c, device, seed, widest)
    _step(out, "kernels")
    rng = Rng(seed)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    zero_counts()
    t0 = time.time()
    proof = prover.prove(z, r, s)
    torch.cuda.synchronize()
    out["prove_s"] = time.time() - t0
    out["launches_per_prove"] = launches = _mnt_counts(MNT_MAIN, f"{curve} prove", g2_deg)
    out["launches_by_size"] = launch_sizes()
    zero_counts()
    assembled = prover.prove(z, r, s, host_assembly=False)
    assembly = _mnt_counts(MNT_ASSEMBLY, f"{curve} device-assembled prove", g2_deg)
    if not _same(assembled, proof):
        raise AssertionError(f"the {curve} device-assembled proof differs from the host-assembled one")
    _verify_all(keep["vk"], [proof, assembled], curve)
    z_enc = prover.encode_assignment(z)
    t0 = time.time()
    _, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    prof["profile_s"] = time.time() - t0
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    out.update(device_assembly_launches_per_prove=assembly, device_assembly_equal=True, proofs_verified=2,
               wrong_input_rejected=True, profile=prof, card=card_line())
    _step(out, "prove")
    if prover.dpk.domain.radixes:
        out["mixed_radix_fft"] = _mnt_fft_check(prover.dpk.domain, device, seed)
        _step(out, "fft")
    del keep, prover, pk
    phase_reference(device, curve)
    return ({curve: launches, f"{curve}_device_assembly": assembly}, rows)


def phase_mnt(device):
    """MNT4-298 at 2^16 (G2 over Fq2 with NR = 17, a = 2) and MNT6-298 at
    the bench's 2^20 (its Fr's mixed-radix domain of 2^15 * 35, G2 over
    Fq3, a = 11), each through _phase_mnt, after K1 at L = 21 against its
    plain version (K1_SIZES_MNT).  Returns the launches by path and the
    kernel rows of each curve."""
    import numpy as np

    rows = {"mont_mul": _mont_mul_kernel(np.random.default_rng(0x298), device, K1_SIZES_MNT)}
    launches, by_curve = {}, {}
    for curve, log_n, seed in ((MNT4_CURVE, MNT4_LOG_N, 0x4A), (MNT6_CURVE, MNT6_LOG_N, 0x6A)):
        l, r = _phase_mnt(device, curve, log_n, seed)
        launches.update(l)
        by_curve[curve] = r
    return launches, rows, by_curve


# The MNT cycle's recursion circuit (r1cs/gadget_circuit.py:
# MntVerifierCircuit): an MNT4-298 proof, made on the card, verified inside
# an MNT6-298 circuit of 69,597 constraints that the card sets up and
# proves on 2^17 points, Fr's 2-adicity: the largest radix-2 domain
RECURSION_INNER_SEED = 0x4427  # tests/test_gadget_mnt.py's inner setup
RECURSION_INNER_AB = (19, 29)  # and its a and b
RECURSION_SEED = 0x6E6
RECURSION_STEADY = 3
# the capture step of the prove's own rows that the kernel check takes:
# the RECURSION_CAPTURE_STEP-th at the widest width of its group (its
# accumulators then no longer all infinity)
RECURSION_CAPTURE_STEP = 8
RECURSION_CHILD_TIMEOUT_S = 600
MNT_SETUP_KERNELS = ("mont_mul", "add_g1", "add_g2")


def _child_main(send, fn, args):
    send.send(fn(*args))
    send.close()


def _spawn(fn, *args):
    """fn(*args) (a function of this module, which runs nothing on the
    card) in a spawned child process -> (the process, the pipe end its
    result arrives on)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_child_main, args=(send, fn, args), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def _joined(child, what, timeout=RECURSION_CHILD_TIMEOUT_S):
    """The result of a _spawn child, which is then joined (ended if it
    lingers); raises if it failed or took longer than `timeout`."""
    proc, recv = child
    try:
        if not recv.poll(timeout):
            raise AssertionError(f"{what}: no result within {timeout} s")
        try:
            return recv.recv()
        except EOFError:
            proc.join(30)
            raise AssertionError(f"{what} failed in its child process (exit code {proc.exitcode})") from None
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join()


def _recursion_cs(vk, proof, pub, mode="PROVE"):
    """MntVerifierCircuit(vk, proof, pub) synthesized over MNT6-298's r."""
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.r1cs.gadget_circuit import MNT_OUTER, MntVerifierCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

    cs = ConstraintSystem(get_curve(MNT_OUTER).r, mode=SynthesisMode[mode])
    MntVerifierCircuit(vk, proof, pub)(cs)
    return cs


def _recursion_exact_h(vk, proof, pub):
    """(In a child process.)  The recursion circuit synthesized, whether
    it is satisfied, and the exact host witness map
    (qap/reduction.py: LibsnarkReduction.witness_map_from_matrices) of
    its assignment -> (h, satisfied, seconds by step)."""
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.qap.reduction import LibsnarkReduction
    from groth16_tpu_torch.r1cs.gadget_circuit import MNT_OUTER

    secs, t0 = {}, time.time()
    cs = _recursion_cs(vk, proof, pub)
    secs["synthesis"] = time.time() - t0
    t0 = time.time()
    satisfied = cs.is_satisfied()
    secs["is_satisfied"] = time.time() - t0
    t0 = time.time()
    m = cs.to_matrices()
    secs["to_matrices"] = time.time() - t0
    t0 = time.time()
    h = LibsnarkReduction.witness_map_from_matrices(
        m, get_curve(MNT_OUTER).fr, m.num_instance_variables, m.num_constraints, cs.full_assignment())
    secs["witness_map"] = time.time() - t0
    return h, satisfied, secs


def _recursion_wrong_input(vk, proof, pub):
    """(In a child process.)  The recursion circuit synthesized with the
    public input `pub` -> (its full assignment, satisfied, seconds)."""
    t0 = time.time()
    cs = _recursion_cs(vk, proof, pub)
    return cs.full_assignment(), cs.is_satisfied(), time.time() - t0


def _matrix_tuple(m):
    return m.num_instance_variables, m.num_witness_variables, m.num_constraints, m.a, m.b, m.c


def _recursion_inner(device):
    """tests/test_gadget_mnt.py's inner proof made on the card:
    setup_device of MySillyCircuit on MNT4-298 with Rng(0x4427), then
    TorchProver with a = 19 and b = 29 (counted: K1 at L = 21, the
    generic-a additions and capture steps launch); the proof must equal
    the exact prover's on the same key, r and s, verify with a b mod r and
    fail with a b + 1.  -> (vk, proof, public input, what it measured)."""
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover import create_proof_with_reduction
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.circuits import MySillyCircuit
    from groth16_tpu_torch.r1cs.gadget_circuit import MNT_INNER
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(MNT_INNER)
    rng = Rng(RECURSION_INNER_SEED)
    t0 = time.time()
    pk, vk = setup_device(MySillyCircuit(), MNT_INNER, rng, device=device)
    setup_s = time.time() - t0
    a, b = RECURSION_INNER_AB
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    circuit = MySillyCircuit(a=a, b=b)
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    circuit(cs)
    prover = TorchProver(pk, cs.to_matrices(), device=device)
    zero_counts()
    t0 = time.time()
    proof = prover.prove(cs.full_assignment(), r, s)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    launches = _mnt_counts(MNT_MAIN, f"the inner {MNT_INNER} prove", c.g2_field_degree)
    if not _same(proof, create_proof_with_reduction(circuit, pk, r, s)):
        raise AssertionError("the inner MNT4-298 proof on the card differs from the exact prover's")
    pub = [a * b % c.r]
    pvk = prepare_verifying_key(vk)
    if not verify_proof(pvk, proof, pub) or verify_proof(pvk, proof, [(pub[0] + 1) % c.r]):
        raise AssertionError("the inner MNT4-298 proof does not verify, or verifies a wrong input")
    return vk, proof, pub, {
        "circuit": f"MySillyCircuit(a={a}, b={b}) on {MNT_INNER}", "setup_s": setup_s, "prove_s": prove_s,
        "launches": launches, "equal_to_exact_prover": True, "verified": True, "wrong_input_rejected": True}


def _recording_capture_steps(prove):
    """prove(), and the inputs of one capture step of each group
    (CurveDevice.capture_step) at the widest width the prove ran it: its
    RECURSION_CAPTURE_STEP-th step there (its first where there are
    fewer), cloned before the kernel writes its captures in place."""
    from groth16_tpu_torch.curves.point import CurveDevice

    real, kept, seen = CurveDevice.capture_step, {}, {}

    def step(self, acc, xy, cap=None, jk=None, src=None, k_prev=-1, add=True):
        name = "capture_step_g2" if self.k.tower_deg > 1 else "capture_step_g1"
        n = acc[0].shape[-1]
        width, count = seen.get(name, (0, 0))
        if add and cap is not None and n >= width:
            count = count + 1 if n == width else 1
            seen[name] = (n, count)
            if count in (1, RECURSION_CAPTURE_STEP):
                clone = lambda pt: tuple(x.clone() for x in pt)  # noqa: E731
                kept[name] = (self, clone(acc), clone(xy), clone(cap), jk.clone(), src.clone(), k_prev)
        return real(self, acc, xy, cap, jk, src, k_prev, add)

    CurveDevice.capture_step = step
    try:
        return prove(), kept
    finally:
        CurveDevice.capture_step = real


def _recorded_capture_steps(c, kept, device):
    """The generic-a group kernel's capture step (_capture_call) on the
    inputs _recording_capture_steps kept from a prove (its own rows,
    accumulators and captures); its bound counts the additions whose two
    operands are finite (the data's work).  -> kernels-line rows."""
    entries = {}
    for name, (g, acc, xy, cap, jk, src, k_prev) in sorted(kept.items()):
        n = acc[0].shape[-1]
        row_inf = ~(xy[1].reshape(-1, n) != 0).any(dim=0)
        acc_inf = g.is_infinity(acc)
        live = int((~row_inf & ~acc_inf).sum())
        row = {"kernel": name, "curve": c.name, "rows": "the recursion prove's own", "tolerance": 0,
               "rows_at_infinity": int(row_inf.sum()), "accumulators_at_infinity": int(acc_inf.sum()),
               "live_additions": live, **_capture_call(g, c, acc, xy, cap, jk, src, k_prev, live),
               "card": card_line()}
        emit({"phase": "mnt_recursion", **row})
        entries[name] = {"name": name, "route": "cuda", "source": "groth16_tpu_torch/csrc/general_add.cu",
                         "replaces": "groth16_tpu/msm/scans.py:192", **_kline(row), "at_n": n}
    if set(entries) != {"capture_step_g1", "capture_step_g2"}:
        raise AssertionError(f"the recursion prove ran no capture step of some group: {sorted(entries)}")
    return entries


def _recursion_k1(dpk, z_enc):
    """K1 at the recursion prove's widest launches: the B and the A
    matvec's products (coefficients x the assignment gathered by column,
    2,542,106 and 1,835,509 elements), and 2^17 (the domain's size) of
    the B operands, against its plain version and timed (_k1_row).  ->
    the kernels-line row (B's)."""
    fr = dpk.fr_spec
    rows = []
    for label, key in (("B matvec", "b"), ("A matvec", "a"), ("2^17 of the B matvec's", "b")):
        dm = dpk.mats[key]
        a, b = dm.coeffs, z_enc[:, dm.cols]
        if label.startswith("2^17"):
            n = dpk.domain.size
            a, b = a[:, :n].contiguous(), b[:, :n].contiguous()
        n = b.shape[-1]
        row = {"kernel": "K1 mont_mul", "field": "mnt6_298.Fr", "operands": label, "n": n, "period": None,
               **_k1_row(fr, a, b, n, None, sweep=label == "B matvec")}
        emit({"phase": "mnt_recursion", **row})
        rows.append(row)
        del a, b
    return {"name": "mont_mul", "route": "cuda", "source": "groth16_tpu_torch/csrc/mont_mul.cu",
            "replaces": "groth16_tpu/fields/pallas_fp.py:114", **_kline(rows[0]), "n": rows[0]["n"],
            "ms_by_n": {r["n"]: r["ms"] for r in rows}, "bound_ms_by_n": {r["n"]: r["bound_ms"] for r in rows}}


def phase_mnt_recursion(device):
    """The MNT cycle's recursion circuit on the card: the inner MNT4-298
    proof (_recursion_inner), the small cycle circuit (G1AddCircuit over
    MNT4-298, _gadget_circuit), then MntVerifierCircuit on that proof
    (69,597 constraints over MNT6-298's r): its SETUP shape equal to its
    PROVE shape, setup_device at 2^17 (phase-timed, counted, peak memory,
    64 points of each query checked on the host), TorchProver (the matrix
    encode timed), one counted prove (K1 at L = 21, the generic-a
    additions and capture steps, Horner; no K2, K3, K6 or K7; no plain
    version on the card), h equal to the exact host witness map, a
    device-assembled prove equal to the host-assembled one, both verified
    with [] on the native and the Python engine, the assignment of the
    inner input + 1 (unsatisfied) proved and rejected, RECURSION_STEADY
    steady proves (the last phase-timed) and one profiled, the fft at 2^17
    against a direct evaluation, and the kernels at the prove's shapes
    against their plain versions (K1 at its widest launches, the
    generic-a kernel at its widest, the capture step on the prove's own
    rows, Horner, the scalar multiplication).  The exact witness map and
    the wrong-input synthesis run in two child processes beside the card
    work.  Returns (launches by path, kernels-line rows)."""
    import torch

    from groth16_tpu_torch.curves import cuda_point
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.fields import cuda_fp
    from groth16_tpu_torch.fields.spec import decode
    from groth16_tpu_torch.protocol import device_keys
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.qap.device import rows_window, sparse_matvec, witness_map_device
    from groth16_tpu_torch.r1cs.gadget_circuit import MNT_INNER, MNT_OUTER, MntVerifierCircuit
    from groth16_tpu_torch.ref.domain import RefDomain
    from groth16_tpu_torch.utils.profiling import PhaseTimer
    from groth16_tpu_torch.utils.rng import Rng

    t_phase = time.time()
    c, inner = get_curve(MNT_OUTER), get_curve(MNT_INNER)
    deg = c.g2_field_degree
    out = {"phase": "mnt_recursion", "inner": MNT_INNER, "outer": MNT_OUTER}
    vk4, proof4, pub, out["inner_proof"] = _recursion_inner(device)
    _step(out, "inner_proof")
    out["g1_add_circuit"] = _gadget_circuit(device, MNT_INNER, lambda what: _mnt_counts(MNT_MAIN, what, deg))
    _step(out, "g1_add_circuit")
    wrong = [(pub[0] + 1) % inner.r]
    children = {"exact_h": _spawn(_recursion_exact_h, vk4, proof4, pub),
                "wrong_input": _spawn(_recursion_wrong_input, vk4, proof4, wrong)}
    try:
        t0 = time.time()
        cs = _recursion_cs(vk4, proof4, pub)
        out["synthesis_s"] = time.time() - t0
        t0 = time.time()
        m, z = cs.to_matrices(), cs.full_assignment()
        out["to_matrices_s"] = time.time() - t0
        del cs
        out.update(constraints=m.num_constraints, instance_variables=m.num_instance_variables,
                   witness_variables=m.num_witness_variables,
                   nonzeros={k: sum(len(row) for row in getattr(m, k)) for k in "abc"},
                   longest_row={k: max(len(row) for row in getattr(m, k)) for k in "abc"},
                   assignment_zero_or_one_share=sum(v < 2 for v in z) / len(z))
        _step(out, "synthesis")

        # setup on the card, the SETUP-mode circuit kept for the shape check
        shaped = []

        def circuit(cs_):
            MntVerifierCircuit()(cs_)
            shaped.append(cs_)

        timer = PhaseTimer(verbose=False, device="cuda")
        record = {}
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.time()
        pk, vk = setup_device(circuit, MNT_OUTER, Rng(RECURSION_SEED), timer=timer, record=record)
        torch.cuda.synchronize()
        out["setup_s"] = time.time() - t0
        out["setup_phases_s"] = timer.as_dict()
        out["setup_launches"] = setup_launches = _mnt_counts(
            MNT_SETUP_KERNELS, "the recursion circuit's setup", deg, kinds=("add",))
        out["setup_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        ref = RefDomain(c.fr, m.num_constraints + m.num_instance_variables)
        out["domain"] = {"size": ref.size, "two_adicity": c.fr.two_adicity,
                         "device_qap": ref.size == 1 << (ref.size.bit_length() - 1)
                         and ref.size.bit_length() - 1 <= c.fr.two_adicity}
        if len(vk.gamma_abc_g1) != 1:
            raise AssertionError(f"the outer statement has {len(vk.gamma_abc_g1) - 1} public inputs, not 0")
        t0 = time.time()
        if _matrix_tuple(shaped.pop().to_matrices()) != _matrix_tuple(m):
            raise AssertionError("MntVerifierCircuit's SETUP-mode shape differs from its PROVE-mode one")
        out["setup_shape_equal_to_prove_shape"] = True
        out["shape_check_s"] = time.time() - t0
        t0 = time.time()
        out["sampled_points_checked"] = _check_sampled(MNT_OUTER, pk, record)
        out["sampled_check_s"] = time.time() - t0
        del record
        _step(out, "setup")

        # the prover: the key and the matrices on the card
        encode, spent = device_keys.encode_matrices, {}

        def timed_encode(*args, **kw):
            t0 = time.time()
            mats = encode(*args, **kw)
            torch.cuda.synchronize()
            spent["s"] = time.time() - t0
            return mats

        torch.cuda.reset_peak_memory_stats()
        device_keys.encode_matrices = timed_encode
        t0 = time.time()
        try:
            prover = TorchProver(pk, m)
        finally:
            device_keys.encode_matrices = encode
        torch.cuda.synchronize()
        if prover.device.type != "cuda":
            raise AssertionError(f"TorchProver's default device is {prover.device}")
        dpk = prover.dpk
        nbytes = lambda ts: sum(x.numel() * x.element_size() for x in ts)  # noqa: E731
        out.update(pk_upload_s=time.time() - t0, matrix_encode_s=spent["s"],
                   matrix_coeff_bytes=nbytes(dm.coeffs for dm in dpk.mats.values()),
                   key_point_bytes=nbytes([x for grp in dpk.g1_groups for x in grp] + list(dpk.b_g2_tail)),
                   matvec_steps={k: (dm.max_row_len - 1).bit_length() for k, dm in dpk.mats.items()},
                   g1_lane_groups=[list(info) for info in dpk.g1_group_info])
        _step(out, "upload")

        rng = Rng(RECURSION_SEED + 1)
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        zero_counts()
        t0 = time.time()
        proof = prover.prove(z, r, s)
        torch.cuda.synchronize()
        out["first_prove_s"] = time.time() - t0
        out["launches_per_prove"] = launches = _mnt_counts(MNT_MAIN, "the recursion prove", deg)
        out["launches_by_size"] = launch_sizes()
        widest = {k: cuda_point.LARGEST_LAUNCH[k] for k in ("add_g1", "add_g2")}
        if cuda_fp.LARGEST_LAUNCH["mont_mul"] != max(dm.coeffs.shape[-1] for dm in dpk.mats.values()):
            raise AssertionError(f"K1's widest launch {cuda_fp.LARGEST_LAUNCH['mont_mul']} is not the B matvec's")
        zero_counts()
        assembled, kept = _recording_capture_steps(lambda: prover.prove(z, r, s, host_assembly=False))
        out["device_assembly_launches_per_prove"] = assembly = _mnt_counts(
            MNT_ASSEMBLY, "the recursion device-assembled prove", deg)
        if not _same(assembled, proof):
            raise AssertionError("the recursion circuit's device-assembled proof differs from the host-assembled one")
        z_enc = prover.encode_assignment(z)
        h = witness_map_device(dpk.fr_spec, dpk.domain, dpk.mats, z_enc, dpk.num_inputs, dpk.num_constraints)
        h = decode(h.cpu().numpy(), dpk.fr_spec)
        h_exact, satisfied, out["exact_host_s"] = _joined(children["exact_h"], "the exact witness map")
        if not satisfied:
            raise AssertionError("the recursion circuit is unsatisfied")
        if h != h_exact:
            raise AssertionError("the recursion prove's h differs from the exact witness map's")
        out["h_equal_to_exact_witness_map"] = True
        out["verify_s"] = {"host_assembled": _verify_engines(vk, proof, public=(), reps=1),
                           "device_assembled": _verify_engines(vk, assembled, public=(), reps=1)}
        z_bad, bad_satisfied, out["wrong_input_synthesis_s"] = _joined(children["wrong_input"], "the wrong input")
        if bad_satisfied:
            raise AssertionError("the recursion circuit accepted a wrong inner public input")
        pvk = prepare_verifying_key(vk)
        if verify_proof(pvk, prover.prove(z_bad, r, s), []):
            raise AssertionError("the proof of the unsatisfied recursion assignment verifies")
        out["unsatisfied_assignment_rejected"] = True
        _step(out, "prove")

        timer = PhaseTimer(verbose=False, device="cuda")
        walls, proofs = [], []
        for i in range(RECURSION_STEADY):
            t0 = time.time()
            proofs.append(prover.prove_encoded_host(z_enc, r, s, timer=timer if i == RECURSION_STEADY - 1 else None))
            walls.append(time.time() - t0)
        steady, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
        if prof["device_busy_s"] is not None:
            prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
        if not all(_same(x, proof) for x in proofs + [steady]):
            raise AssertionError("a steady recursion proof differs from the first")
        out.update(steady_prove_s=walls, phases_s=timer.as_dict(), profile=prof,
                   prove_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=card_line())
        # the witness map's parts on the card (CUDA events): each matvec,
        # and one transform of the seven
        padded = rows_window(z_enc, 0, dpk.domain.size)
        out["witness_map_parts_ms"] = {
            **{f"matvec_{k}": time_ms(lambda dm=dm: sparse_matvec(dpk.fr_spec, dm, z_enc), reps=3)
               for k, dm in dpk.mats.items()},
            "fft": time_ms(lambda: dpk.domain.fft(padded), reps=3),
            "whole": time_ms(lambda: witness_map_device(dpk.fr_spec, dpk.domain, dpk.mats, z_enc, dpk.num_inputs,
                                                        dpk.num_constraints), reps=3)}
        _step(out, "steady")

        out["fft"] = _mnt_fft_check(dpk.domain, device, RECURSION_SEED)
        g = dpk.domain.group_gen
        if (g != ref.group_gen or pow(g, ref.size, c.r) != 1 or pow(g, ref.size // 2, c.r) == 1
                or dpk.domain.evaluate_vanishing_polynomial(c.fr.generator)
                != ref.evaluate_vanishing_polynomial(c.fr.generator)):
            raise AssertionError("the 2^17 domain's root or vanishing polynomial differs from the exact domain's")
        _step(out, "fft")

        rows = {"mont_mul": _recursion_k1(dpk, z_enc),
                **_point_kernels(dpk, c, widest, device, mixed=(False,)),
                **_recorded_capture_steps(c, kept, device),
                **_horner_kernels(_prove_horner_shapes(dpk), c, device)}
        del kept
        rows.update(_scalar_mul_kernels(lambda g_: _key_points(dpk, g_), c, device, rows, RECURSION_SEED,
                                        extra_lanes=()))
        out["kernels_at_n"] = {"add_g1": widest["add_g1"], "add_g2": widest["add_g2"],
                               **{k: rows[k]["at_n"] for k in ("capture_step_g1", "capture_step_g2")}}
    finally:
        for proc, _ in children.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
    out["phase_s"] = time.time() - t_phase
    _step(out, "kernels")
    return ({"mnt_recursion": launches, "mnt_recursion_device_assembly": assembly,
             "mnt_recursion_setup": setup_launches,
             "mnt_recursion_inner": out["inner_proof"]["launches"],
             "mnt_recursion_g1_add_circuit": out["g1_add_circuit"]["launches"]}, rows)


VERIFY_REPS = 5


def _verify_engines(vk, proof, public=(15,), reps=VERIFY_REPS) -> dict:
    """Seconds of one verify_proof (with `public`), the mean of `reps`,
    on the native engine and on the pure-Python engine (the verifier's
    native_pairing hidden for the second); both must accept."""
    from groth16_tpu_torch.protocol import verifier

    pvk = verifier.prepare_verifying_key(vk)
    out = {}
    native = verifier.native_pairing
    for engine in ("native", "python"):
        if engine == "python":
            verifier.native_pairing = lambda curve: None
        try:
            t0 = time.time()
            ok = all(verifier.verify_proof(pvk, proof, list(public)) for _ in range(reps))
            out[engine] = (time.time() - t0) / reps
        finally:
            verifier.native_pairing = native
        if not ok:
            raise AssertionError(f"the proof does not verify on the {engine} engine")
    return out


def _k3_at_shape(dpk, c, shape, rng, device):
    """K3 of curve c timed (time_ms) on filled rows of its key's G2 points
    at another prove's (rows, steps, chunks, S), and at S = 1: the same
    work at another Fq2 nonresidue."""
    from groth16_tpu_torch.curves import codec
    from groth16_tpu_torch.msm import cuda_scan

    R, K, C, S = shape
    g = codec.g2_ops(c)
    pts = tuple(x[..., None, : K * C] for x in dpk.b_g2_tail)
    rows = _scan_rows(g, pts, R, K * C, rng, device)

    def run(seg):
        return cuda_scan.suffix_scan_g2_rows(g.k.spec, g.k.nr_int, g.b3_val, rows, K, C, segments=seg)

    emit({"phase": "kernels", "kernel": "K3 suffix_scan_g2 at another curve's shape", "curve": c.name,
          "fq2_nonresidue": c.fp2_nonresidue, "rows_steps_chunks": [R, K, C], "segments": S,
          "ms": time_ms(lambda: run(S)), "ms_s1": time_ms(lambda: run(1)), "card": card_line()})


def phase_bls(device, k3_shape=None):
    """The 2^20 bls12_381 DummyCircuit: device setup, sampled key check,
    TorchProver on cuda (one counted prove, 2 steady ones, the capture
    scan), verify; K3 also at k3_shape (bls12_377's (rows, steps,
    chunks, S), for its NR = -5 beside this NR = -1).  Returns the
    launches of the fused and the capture prove by path, and the L = 26
    kernel checks."""
    import numpy as np
    import torch

    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.protocol.generator_torch import setup_device
    from groth16_tpu_torch.protocol.prover_torch import TorchProver
    from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
    from groth16_tpu_torch.r1cs.circuits import DummyCircuit
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
    from groth16_tpu_torch.utils.profiling import PhaseTimer
    from groth16_tpu_torch.utils.rng import Rng

    c = get_curve(BLS_CURVE)
    n_constraints, n_vars = (1 << BLS_LOG_N) - 2, 1 << (BLS_LOG_N - 1)
    out = {"phase": "bls12_381_2p20", "curve": BLS_CURVE, "log_n": BLS_LOG_N,
           "constraints": n_constraints, "variables": n_vars}
    timer = PhaseTimer(verbose=False, device="cuda")
    record = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    pk, vk = setup_device(DummyCircuit(n_vars, n_constraints), BLS_CURVE, Rng(0xB15), timer=timer, record=record)
    torch.cuda.synchronize()
    out["setup_s"] = time.time() - t0
    out["setup_phases_s"] = timer.as_dict()
    out["setup_launches"] = read_counts(SETUP_KERNELS)
    out["setup_launches_by_size"] = launch_sizes()
    out["setup_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["key_points"] = {"g1": sum(record["counts"]) + 3, "g2": record["counts"][1] + 3}
    _step(out, "setup")
    t0 = time.time()
    out["sampled_points_checked"] = _check_sampled(BLS_CURVE, pk, record)
    out["sampled_check_s"] = time.time() - t0
    del record

    t0 = time.time()
    cs = ConstraintSystem(c.r, mode=SynthesisMode.PROVE)
    DummyCircuit(n_vars, n_constraints, a=3, b=5)(cs)
    matrices, z = cs.to_matrices(), cs.full_assignment()
    out["prove_synthesis_s"] = time.time() - t0
    t0 = time.time()
    prover = TorchProver(pk, matrices)
    out["pk_upload_s"] = time.time() - t0
    _step(out, "upload")
    # the L = 26 builds of K4-K7 at N = 2^16 and of K2/K3 at this prove's
    # rows, steps and chunks, against their plain version
    krng = np.random.default_rng(0xB17)
    rows = {**_point_kernels(prover.dpk, c, N_KERNEL, device, mixed=(False, True)),
            **_horner_kernels(_prove_horner_shapes(prover.dpk), c, device),
            **_scan_kernels(prover.dpk, c, krng, device, sweep=False)}
    rows.update(_scalar_mul_kernels(lambda g: _key_points(prover.dpk, g), c, device, rows, 0x5CA2))
    if k3_shape is not None:
        _k3_at_shape(prover.dpk, c, k3_shape, krng, device)
    _add_sweep(lambda g: _key_points(prover.dpk, g), c, device, ("add_g1", "add_g2", "add_mixed_g1"))
    _k6_forms(lambda g: _key_points(prover.dpk, g), c, device)
    rng = Rng(0xB16)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    first = (r, s)
    # the proves' peak (the key stays resident), not the kernel checks'
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.time()
    proofs = [prover.prove(z, r, s)]
    torch.cuda.synchronize()
    out["first_prove_s"] = time.time() - t0
    launches = read_counts(MAIN_KERNELS)
    out["launches_per_prove"] = launches
    out["launches_by_size"] = sizes = launch_sizes()
    z_enc = prover.encode_assignment(z)
    ptimer = PhaseTimer(verbose=False, device="cuda")
    walls = []
    for i in range(2):
        r, s = rng.field_element(c.r), rng.field_element(c.r)
        t0 = time.time()
        proofs.append(prover.prove_encoded_host(z_enc, r, s, timer=ptimer if i == 1 else None))
        walls.append(time.time() - t0)
    out["steady_prove_s"] = walls
    out["phases_s"] = ptimer.as_dict()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # K4/K5 at 2^17 points (the G2 tail) and at the most points of one of
    # the prove's launches (after the peak: the plain versions take more)
    widest = {k: sorted({1 << 17, sizes[k]["largest"]}) for k in ("add_g1", "add_g2")}
    out["add_digit_equal_at_n"] = _check_adds(lambda g: _key_points(prover.dpk, g), c, device, widest)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    proof, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    proofs.append(proof)
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    out["profile"] = prof
    # the steady prove with the segment chooser's steps a segment set to
    # each of PROVE_SEGMENT_STEPS (S = K // steps where the columns leave
    # SMs idle; 1,024 steps: S = 1), two proves each
    from groth16_tpu_torch.msm import cuda_scan

    chosen, by_steps = cuda_scan.MIN_SEGMENT_STEPS, {}
    try:
        for steps in PROVE_SEGMENT_STEPS:
            cuda_scan.MIN_SEGMENT_STEPS = steps
            by_steps[steps] = []
            for _ in range(2):
                r, s = rng.field_element(c.r), rng.field_element(c.r)
                t0 = time.time()
                proofs.append(prover.prove_encoded_host(z_enc, r, s))
                torch.cuda.synchronize()
                by_steps[steps].append(time.time() - t0)
    finally:
        cuda_scan.MIN_SEGMENT_STEPS = chosen
    out["steady_prove_s_by_segment_steps"] = by_steps
    out["card"] = card_line()
    _step(out, "prove")
    # the device assembly with the first prove's r and s: its proof must
    # equal the fused host-assembly one
    zero_counts()
    t0 = time.time()
    dev = prover.prove(z, *first, host_assembly=False)
    out["device_assembly_prove_s"] = time.time() - t0
    assembly = read_counts(MAIN_KERNELS + ("scalar_mul_g1", "scalar_mul_g2"))
    if not _same(dev, proofs[0]):
        raise AssertionError("the 2^20 device-assembled proof differs from the host-assembled one")
    proofs.append(dev)
    out["device_assembly_launches_per_prove"] = assembly
    nums, host, assembled = _device_assembly(prover, z_enc, *first)
    if not (_same(host, proofs[0]) and _same(assembled, proofs[0])):
        raise AssertionError("the 2^20 device assembly differs from the host assembly")
    out["device_assembly"] = {**nums, "equal_to_host_assembly": True, "card": card_line()}
    _step(out, "device_assembly")
    capture, capture_proofs = _bls_capture(out, prover, z_enc, first, proofs[0], c, device)
    proofs += capture_proofs
    t0 = time.time()
    pvk = prepare_verifying_key(vk)
    out["prepare_vk_s"] = time.time() - t0
    t0 = time.time()
    for i, proof in enumerate(proofs):
        if not verify_proof(pvk, proof, [15]):
            raise AssertionError(f"bls12_381 proof {i} does not verify")
        if verify_proof(pvk, proof, [16]):
            raise AssertionError(f"bls12_381 proof {i} verifies with a wrong public input")
    out["verify_s_per_check"] = (time.time() - t0) / (2 * len(proofs))
    out.update(proofs_verified=len(proofs), wrong_input_rejected=True)
    out.pop("_seen")
    emit(out)
    return {"bls12_381_2p20": launches, "bls12_381_2p20_device_assembly": assembly,
            "bls12_381_2p20_capture": capture}, rows


def _bls_capture(out, prover, z_enc, first, want, c, device):
    """The 2^20 prove on the capture scan (K6/K7 a step) with the first
    fused prove's r and s: one counted and phase-timed, one under
    torch.profiler; both proofs must equal the fused one.  K6 and K7 are
    then held against their plain versions at the most points of one of
    their launches.  Returns the launches and the two proofs."""
    import torch

    from groth16_tpu_torch.config import configure
    from groth16_tpu_torch.utils.profiling import PhaseTimer

    r, s = first
    timer = PhaseTimer(verbose=False, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with configure(msm_fused_scan=False):
        zero_counts()
        t0 = time.time()
        proof, k6_sizes = _recording_k6_sizes(lambda: prover.prove_encoded_host(z_enc, r, s, timer=timer))
        proofs = [proof]
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts(CAPTURE_KERNELS)
        sizes = launch_sizes()
        proof, prof = profile_prove(lambda: prover.prove_encoded_host(z_enc, r, s))
    proofs.append(proof)
    for p in proofs:
        if (p.a, p.b, p.c) != (want.a, want.b, want.c):
            raise AssertionError("the 2^20 capture-scan proof differs from the fused-scan proof")
    if prof["device_busy_s"] is not None:
        prof["device_busy_share"] = prof["device_busy_s"] / prof["profiled_wall_s"]
    widest = {k: [sizes[k]["largest"]] for k in ("add_mixed_g1", "add_mixed_g2")}
    src_of = lambda g: _key_points(prover.dpk, g)  # noqa: E731
    _check_adds(src_of, c, device, widest)
    out["capture"] = {
        "msm_scan": "capture", "prove_s": wall, "phases_s": timer.as_dict(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches_per_prove": launches,
        "launches_by_size": sizes, "equal_to_fused_proof": True, "k6_k7_digit_equal_at_n": widest,
        "k6_launches_by_points": k6_sizes, "profile": prof, "card": card_line(),
    }
    # K6's two forms at the points of this prove's launches
    _k6_forms(src_of, c, device, sizes=list(k6_sizes), check=False, rounds=1)
    _step(out, "capture")
    return launches, proofs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import groth16_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda")
    phase_card()
    ubench_entries = phase_ubench(device)
    pk, vk, cs, rng = phase_setup()
    entries = phase_kernels(pk, cs.to_matrices(), device)
    phase_reference(device)
    prover, launches, first = phase_main_path(pk, vk, cs, rng, device)
    capture = phase_capture_path(prover, cs, first)
    paths = {**phase_batch(prover, vk, cs, rng), **phase_device_assembly(prover, vk, cs, rng)}
    multi, multi_rows = phase_multi_device(pk, vk, cs, prover, first)
    paths.update(multi)
    del prover
    setup = phase_device_setup(pk)
    del pk, vk, cs
    b377, b377_rows, k3_shape = phase_bls377(device)
    bw6, bw6_rows = phase_bw6(device)
    bls, bls_rows = phase_bls(device, k3_shape)
    mnt, mnt_k1, mnt_rows = phase_mnt(device)
    recursion, recursion_rows = phase_mnt_recursion(device)
    mnt.update(recursion)
    kernels = []
    for name, e in entries.items():
        by_path = {"main": launches.get(name, 0), "capture": capture.get(name, 0),
                   **{p: n.get(name, 0) for p, n in paths.items()},
                   "setup": setup.get(name, 0), **{p: n.get(name, 0) for p, n in b377.items()},
                   **{p: n.get(name, 0) for p, n in bw6.items()},
                   **{p: n.get(name, 0) for p, n in bls.items()},
                   **{p: n.get(name, 0) for p, n in mnt.items()}}
        for curve, other in ((B377_CURVE, b377_rows), (BW6_CURVE, bw6_rows), (BLS_CURVE, bls_rows),
                             ("sharded_2_ranks", multi_rows),
                             ("L21", mnt_k1), (MNT4_CURVE, mnt_rows[MNT4_CURVE]),
                             (MNT6_CURVE, mnt_rows[MNT6_CURVE]), ("mnt_recursion", recursion_rows)):
            if name in other:
                e = dict(e, **{curve: {k: v for k, v in other[name].items() if k not in e or e[k] != v}})
        # the main path's launches, else those of the first path that ran it
        # (K6/K7: the capture scan; the scalar multiplication: the device
        # assembly)
        path = next((p for p, n in by_path.items() if n), "main")
        kernels.append(dict(e, launches=by_path[path], path=path, launches_by_path=by_path))
    # the generic-a capture step runs on the MNT proves alone: its row is
    # MNT6-298's (the 2^20 prove's widest step), MNT4-298's and the
    # recursion prove's (its own rows) beside it
    for name in ("capture_step_g1", "capture_step_g2"):
        e = dict(mnt_rows[MNT6_CURVE][name], **{MNT4_CURVE: mnt_rows[MNT4_CURVE][name],
                                               "mnt_recursion": recursion_rows[name]})
        by_path = {p: n.get(name, 0) for p, n in mnt.items()}
        kernels.append(dict(e, launches=by_path[MNT6_CURVE], path=MNT6_CURVE, launches_by_path=by_path))
    kernels += list(ubench_entries.values())
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
