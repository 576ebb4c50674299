"""`correct` must come out false for the control (the reference in the
program's place, r and s reused) and for each fault the cells can have,
planted under the timed path of a tiny cell on the CPU: a step that
returns its state unchanged, half of the work left out, an answer
altered where it is produced.  (No cell spans chips, so there is no
exchange between chips to leave out.)"""

import pytest
import torch

import groth16_tpu_torch.par.batch_pp as batch_pp
import groth16_tpu_torch.protocol.prover_torch as prover_torch
from benchmark.lib import check, control, program
from benchmark.lib.cell import Run
from benchmark.reference.groth16 import Reference
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 99


def run(entry, factory=None, seconds=0.5):
    return Run(tiny_cell(entry), SEED, seconds, False, device="cpu", entry_factory=factory).go()


def reused_randomness(r):
    circuit, _ = r.circuit.reference_circuit(r.cfg, r.matrices)
    return control.ReusedRandomness(Reference(r.spec, r.waste, circuit))


@pytest.mark.parametrize("entry", ["single", "stream"])
def test_the_control_is_not_correct(entry):
    line = run(entry, reused_randomness)
    assert line["correct"] is False
    assert line["checks"]["proofs_differing"]["value"] == line["attempted"] - 1 >= 1


@pytest.mark.parametrize("jobs", [4, check.MAX_CHECKED + 6])
def test_control_readings_at_a_tiny_size(jobs):
    cell = tiny_cell("single")
    checks = control.readings(cell.config, cell.traffic, SEED, jobs, device="cpu")
    # the first job's proof is right; past MAX_CHECKED a sample is compared
    assert not check.is_correct(checks)
    assert checks["proofs_differing"]["value"] == min(jobs, check.MAX_CHECKED) - 1


class Stale(program.Entry):
    """A step that returns its state unchanged: every answer is the first."""

    def __init__(self, r):
        super().__init__(r.prover, r.traffic)
        self.first = None

    def single(self, z, r, s, timer=None):
        self.first = self.first or super().single(z, r, s, timer)
        return self.first

    def stream(self, jobs):
        for proof in super().stream(jobs):
            self.first = self.first or proof
            yield self.first


@pytest.mark.parametrize("entry", ["single", "stream"])
def test_a_step_that_returns_its_state_unchanged(entry):
    line = run(entry, Stale)
    assert line["correct"] is False and line["checks"]["proofs_differing"]["value"] >= 1
    assert line["attempted"] > 1


@pytest.mark.parametrize("entry", ["single", "stream"])
def test_half_of_the_work_left_out(entry, monkeypatch):
    real = prover_torch.witness_phase

    def half(dpk, z_mont):
        scalars, rho = real(dpk, z_mont)
        cut = [s.clone() for s in scalars]
        for s in cut:
            s[..., s.shape[-1] // 2:] = 0
        return tuple(cut), rho

    monkeypatch.setattr(prover_torch, "witness_phase", half)
    line = run(entry)
    assert line["correct"] is False and line["checks"]["proofs_differing"]["value"] == line["attempted"]


@pytest.mark.parametrize("entry", ["single", "stream"])
def test_an_answer_altered_where_it_is_produced(entry, monkeypatch):
    real_host, real_device = prover_torch._host_assembly_np, prover_torch.assembly_phase

    def host(*args):
        proof = real_host(*args)
        proof.a = proof.c  # A replaced by C
        return proof

    def device(*args):
        ax, ay, ainf, bx, by, binf = real_device(*args)
        return (torch.flip(ax, [-1]), torch.flip(ay, [-1]), torch.flip(ainf, [-1]), bx, by, binf)

    monkeypatch.setattr(prover_torch, "_host_assembly_np", host)
    monkeypatch.setattr(prover_torch, "assembly_phase", device)
    line = run(entry)
    assert line["correct"] is False and line["checks"]["proofs_differing"]["value"] == line["attempted"]
    assert batch_pp.decode_proof_arrays is prover_torch.decode_proof_arrays
