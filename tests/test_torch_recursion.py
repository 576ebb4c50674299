"""The MNT4-298 -> MNT6-298 recursion circuit of the port
(groth16_tpu_torch.r1cs.gadget_circuit) against the JAX package's gadgets.

- MntVerifierCircuit, on an MNT4-298 proof made by the JAX package's exact
  setup and prover (tests/test_gadget_mnt.py's seed and values), builds the
  same constraint system as the JAX package's verifier-gadget flow
  (Groth16VerifierGadget, VerifyingKeyVar, ProofVar, allocate_input_bits,
  verify): the same counts, matrices and full assignment (69,597
  constraints), and it is satisfied; its SETUP-mode shape equals its
  PROVE-mode one.
- With the inner public input + 1 the port's circuit is unsatisfied.
- G1AddCircuit on the MNT cycle (two MNT4-298 G1 points added in-circuit
  over MNT6-298's r, on G1Var's general-a law), built with each package's
  gadgets, has the same constraint system; TorchProver on the CPU proves
  it with the key of the JAX package's exact MNT6-298 setup, and the proof
  equals the JAX package's exact prover's for the same r and s, verifies
  and fails with a wrong input.  MNT6-298's NttDomain at 2^17, the
  recursion circuit's domain, is radix-2 with the JAX package's group
  generator, of order exactly 2^17 (Fr's 2-adicity), and the same
  vanishing polynomial at the coset generator.

Nothing is proved at the recursion circuit's size here.  Three cases,
~90 s of one worker, most of it the five syntheses of the 69,597-
constraint circuit: pytest-xdist's --dist loadfile hands a file of three
cases out after tests/test_gadget.py.  Tolerance: exact (constraint
systems, field values and points are integers)."""

import importlib

import pytest
import torch

from groth16_tpu.curves.params import get_curve
from groth16_tpu.protocol import setup as jsetup
from groth16_tpu.protocol.prover import create_proof_with_reduction
from groth16_tpu.r1cs.circuits import MySillyCircuit as JSilly
from groth16_tpu.ref.curve import RefGroups
from groth16_tpu.ref.domain import RefDomain
from groth16_tpu.utils.rng import Rng as JRng
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.protocol.data_structures import Proof
from groth16_tpu_torch.protocol.device_keys import proving_key_from_reference
from groth16_tpu_torch.protocol.prover_torch import TorchProver
from groth16_tpu_torch.protocol.verifier import prepare_verifying_key, verify_proof
from groth16_tpu_torch.r1cs.gadget_circuit import G1AddCircuit, MntVerifierCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode

torch.set_num_threads(1)

INNER, OUTER = "mnt4_298", "mnt6_298"


@pytest.fixture(scope="module")
def inner_proof():
    """tests/test_gadget_mnt.py's inner proof: MySillyCircuit on MNT4-298,
    a = 19, b = 29, from the exact setup with Rng(0x4427); -> (the JAX
    package's vk and proof, the port's, the public input)."""
    c = get_curve(INNER)
    rng = JRng(0x4427)
    jpk, jvk = jsetup(JSilly(), INNER, rng)
    a, b = 19, 29
    jproof = create_proof_with_reduction(JSilly(a=a, b=b), jpk, rng.field_element(c.r), rng.field_element(c.r))
    proof = Proof(curve=jproof.curve, a=jproof.a, b=jproof.b, c=jproof.c)
    return jvk, jproof, proving_key_from_reference(jpk).vk, proof, [a * b % c.r]


def _matrices(cs):
    m = cs.to_matrices()
    return m.num_instance_variables, m.num_witness_variables, m.num_constraints, m.a, m.b, m.c


def _port_cs(vk, proof, pub, mode=SynthesisMode.PROVE):
    cs = ConstraintSystem(get_curve(OUTER).r, mode=mode)
    MntVerifierCircuit(vk, proof, pub)(cs)
    return cs


def _jax_cs(vk, proof, pub):
    """tests/test_gadget_mnt.py's verifier-gadget flow, the JAX package's
    gadgets."""
    from groth16_tpu.gadgets import Groth16VerifierGadget, ProofVar, VerifyingKeyVar
    from groth16_tpu.gadgets.groth16_var import allocate_input_bits
    from groth16_tpu.r1cs.system import ConstraintSystem as JCS
    from groth16_tpu.r1cs.system import SynthesisMode as JMode

    cs = JCS(get_curve(OUTER).r, mode=JMode.PROVE)
    gadget = Groth16VerifierGadget(cs, INNER)
    vk_var = VerifyingKeyVar(cs, INNER, vk=vk)
    proof_var = ProofVar(cs, proof)
    bits = allocate_input_bits(cs, pub, len(pub), get_curve(INNER).r.bit_length())
    gadget.verify(vk_var, bits, proof_var)
    return cs


def test_recursion_circuit_matches_jax(inner_proof):
    jvk, jproof, vk, proof, pub = inner_proof
    cs = _port_cs(vk, proof, pub)
    got = _matrices(cs)
    jcs = _jax_cs(jvk, jproof, pub)
    assert got == _matrices(jcs), "matrices differ"
    assert got[:3] == (1, 69_619, 69_597)
    assert cs.full_assignment() == jcs.full_assignment(), "assignments differ"
    del jcs
    assert cs.is_satisfied(), "the port's recursion circuit is unsatisfied"
    shape = _matrices(_port_cs(None, None, None, mode=SynthesisMode.SETUP))
    assert shape == got, "the SETUP-mode shape differs from the PROVE-mode one"


def test_recursion_circuit_rejects_a_wrong_input(inner_proof):
    _, _, vk, proof, pub = inner_proof
    wrong = [(pub[0] + 1) % get_curve(INNER).r]
    assert not _port_cs(vk, proof, wrong).is_satisfied(), "the circuit accepted a wrong public input"


def _g1_add(pkg, P=None, Q=None):
    """G1AddCircuit's statement on the MNT cycle from package `pkg`'s
    gadgets: P + Q on MNT4-298's G1 over MNT6-298's r, the sum's x
    public (P, Q None: the shape).  -> the circuit callable."""
    curve_var = importlib.import_module(f"{pkg}.gadgets.curve_var")
    std = importlib.import_module(f"{pkg}.gadgets.r1cs_std")
    inner = get_curve(INNER)

    def synth(cs):
        def point(pt):
            x = std.FpVar.new_witness(cs, None if pt is None else pt[0])
            y = std.FpVar.new_witness(cs, None if pt is None else pt[1])
            return curve_var.G1Var.from_affine_var(cs, x, y, 3 * inner.b, inner.a)

        x, _ = point(P).add(point(Q)).to_affine()
        std.FpVar.new_input(cs, x.value).enforce_equal(x)

    return synth


def _synth(pkg, circuit):
    """circuit synthesized in package `pkg`'s PROVE-mode constraint
    system over MNT6-298's r."""
    system = importlib.import_module(f"{pkg}.r1cs.system")
    cs = system.ConstraintSystem(get_curve(OUTER).r, mode=system.SynthesisMode.PROVE)
    circuit(cs)
    return cs


def test_mnt_cycle_g1_add_prove_matches_exact():
    c = get_curve(OUTER)
    g = RefGroups(INNER)
    P = g.g1_sample(3)
    Q = g.g1_mul(P, 0xC0FFEE)
    x_sum = g.g1_add(P, Q)[0]
    cs = _synth("groth16_tpu_torch", G1AddCircuit(P, Q, inner=INNER))
    jcs = _synth("groth16_tpu", _g1_add("groth16_tpu", P, Q))
    m = _matrices(cs)
    assert m == _matrices(jcs) == _matrices(_synth("groth16_tpu_torch", _g1_add("groth16_tpu_torch", P, Q)))
    assert cs.full_assignment() == jcs.full_assignment()
    assert cs.is_satisfied() and cs.full_assignment()[1] == x_sum
    with pytest.raises(ValueError):
        G1AddCircuit(P, Q, inner=INNER)(ConstraintSystem(get_curve("bw6_761").r))

    # the JAX package's exact setup and prover; the port's prover on the
    # CPU with the same key, r and s
    rng = JRng(0x6C1)
    jpk, _ = jsetup(_g1_add("groth16_tpu"), OUTER, rng)
    r, s = rng.field_element(c.r), rng.field_element(c.r)
    want = create_proof_with_reduction(_g1_add("groth16_tpu", P, Q), jpk, r, s)
    pk = proving_key_from_reference(jpk)
    got = TorchProver(pk, cs.to_matrices(), device="cpu").prove(cs.full_assignment(), r, s)
    assert (got.curve, got.a, got.b, got.c) == (want.curve, want.a, want.b, want.c)
    pvk = prepare_verifying_key(pk.vk)
    assert verify_proof(pvk, got, [x_sum])
    assert not verify_proof(pvk, got, [(x_sum + 1) % c.r])

    # the recursion circuit's domain: 69,597 + 1 rows -> 2^17, Fr's
    # 2-adicity, so radix-2 with a root of order exactly 2^17
    fr = c.fr
    assert fr.two_adicity == 17
    dom, ref = NttDomain(fr, 69_597 + 1, device="cpu"), RefDomain(fr, 69_597 + 1)
    assert (dom.size, dom.log_size, dom.radixes) == (ref.size, 17, ())
    assert dom.group_gen == ref.group_gen
    assert pow(dom.group_gen, 1 << 17, fr.modulus) == 1 != pow(dom.group_gen, 1 << 16, fr.modulus)
    assert dom.evaluate_vanishing_polynomial(fr.generator) == ref.evaluate_vanishing_polynomial(fr.generator)
