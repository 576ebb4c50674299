"""The system under test: every call the harness makes into the program
(groth16_tpu_torch), and nothing else.  The harness reads the program's
outputs (proofs, the verifying key), its phase spans (PhaseTimer) and
the names of its kernels in the device trace."""

from __future__ import annotations

import contextlib
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_kernels(curves) -> None:
    """Build every CUDA library the curves' prove, device assembly and key
    generation load, one nvcc each, in parallel (a no-op once built: the
    libraries are kept in the checkout, groth16_tpu_torch/_build/)."""
    from groth16_tpu_torch.curves.params import get_curve
    from groth16_tpu_torch.utils import cuda_build

    names = []
    for c in curves:
        names += [n for n in cuda_build.curve_variants(get_curve(c)) if n not in names]
    cuda_build.build(names)


def constraint_system(r: int, prove: bool):
    from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

    return ConstraintSystem(r, mode=SynthesisMode.PROVE if prove else SynthesisMode.SETUP)


def keygen(circuit, curve: str, waste, p1, p2, t_rng, device):
    """The proving key, made on the device from the benchmark's toxic waste
    and generators (the body of the program's setup_device)."""
    from groth16_tpu_torch.protocol.generator_torch import generate_parameters_with_qap_device

    pk = generate_parameters_with_qap_device(
        circuit, curve, waste.alpha, waste.beta, waste.gamma, waste.delta, p1, p2, t_rng, device=device)
    sync(device)
    return pk


def prover(pk, matrices, device):
    from groth16_tpu_torch.protocol.prover_torch import TorchProver

    p = TorchProver(pk, matrices, device=device)
    sync(device)
    return p


def phase_timer(device):
    """The program's PhaseTimer, keeping also each phase's interval inside
    its fences on the wall clock that the profiler stamps device events on:
    `stamps`, (name, start_ns, end_ns)."""
    from groth16_tpu_torch.utils.profiling import PhaseTimer

    class Stamped(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name):
            with PhaseTimer.phase(self, name):
                t0 = time.time_ns()
                yield
            self.stamps.append((name, t0, time.time_ns()))

    timer = Stamped(verbose=False, device=str(torch.device(device)))
    timer.stamps = []
    return timer


def as_tuple(proof) -> tuple:
    return (proof.a, proof.b, proof.c)


class Entry:
    """The program's entry points as a traffic mix drives them: `single`
    (one TorchProver.prove at a time, host or device assembly) and
    `stream` (ProofStream(prover, depth).prove_all, device assembly)."""

    def __init__(self, prover, traffic: dict):
        self.prover, self.traffic = prover, traffic
        self.host_assembly = traffic.get("assembly", "host") == "host"

    def single(self, z, r, s, timer=None):
        return as_tuple(self.prover.prove(z, r, s, timer=timer, host_assembly=self.host_assembly))

    def stream(self, jobs):
        from groth16_tpu_torch.par.batch_pp import ProofStream

        for proof in ProofStream(self.prover, depth=int(self.traffic["depth"])).prove_all(jobs):
            yield as_tuple(proof)
