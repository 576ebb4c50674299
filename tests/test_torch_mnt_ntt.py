"""The port's mixed-radix NTT (the MixedRadixEvaluationDomain fallback of
low-2-adicity fields: MNT6-298's Fr has 2-adicity 17) on the CPU against
the JAX package's NttDomain and the exact engine's RefDomain: fft, ifft
and both cosets on the test field of tests/test_ntt_mixed_device.py (p =
181, p - 1 = 2^2 3^2 5), the witness map on such a domain against the
exact reduction's, and MNT6-298's Fr past its 2-adicity on four sampled
points.  Tolerance: equal values mod p (digit-for-digit against the JAX
package, which runs the same stages).  Three cases, so pytest-xdist's
--dist loadfile hands the file out after tests/test_gadget.py."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from groth16_tpu.curves.params import FieldParams as JFieldParams
from groth16_tpu.ntt import NttDomain as JNttDomain
from groth16_tpu_torch.curves.params import FieldParams, get_curve
from groth16_tpu_torch.fields.spec import decode, encode
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.qap.device import encode_matrices, witness_map_device
from groth16_tpu_torch.qap.reduction import LibsnarkReduction
from groth16_tpu_torch.r1cs.circuits import DummyCircuit
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisMode
from groth16_tpu_torch.ref.domain import RefDomain

torch.set_num_threads(1)

F181 = FieldParams("t181.Fr", 181, 2)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def test_mixed_ntt_matches_jax_and_ref():
    """Sizes 15 (5 * 3), 45 (5 * 3 * 3) and 10 (5 * 2): the transforms
    digit-equal to the JAX package's and equal to RefDomain's values."""
    jf = JFieldParams("t181.Fr", 181, 2)
    for n_req in (13, 41, 10):
        d, jd, rd = NttDomain(F181, n_req, "cpu"), JNttDomain(jf, n_req), RefDomain(F181, n_req)
        assert (d.size, d.group_gen, d.radixes) == (rd.size, rd.group_gen, jd.radixes) and d.radixes
        rng = random.Random(n_req)
        coeffs = [rng.randrange(181) for _ in range(d.size)]
        a = encode(coeffs, d.spec)
        coset = rd.get_coset(F181.generator)
        for name, want in (("fft", rd.fft), ("ifft", rd.ifft), ("coset_fft", coset.fft), ("coset_ifft", coset.ifft)):
            got = getattr(d, name)(_t(a))
            np.testing.assert_array_equal(
                got.numpy().astype(np.uint32), np.asarray(getattr(jd, name)(jnp.asarray(a.astype(np.uint32))))
            )
            assert decode(got.numpy(), d.spec) == want(coeffs), (n_req, name)


def test_witness_map_on_mixed_domain():
    """The device witness map (K1 products, mixed-radix NTTs, the coset
    division by Z) over p = 181 with 13 coefficients (a domain of 15)
    equals the exact reduction's h."""
    cs = ConstraintSystem(181, mode=SynthesisMode.PROVE)
    DummyCircuit(4, 11, a=3, b=5)(cs)
    assert cs.is_satisfied()
    m, z = cs.to_matrices(), cs.full_assignment()
    ni, nc = cs.num_instance_variables, cs.num_constraints
    d = NttDomain(F181, nc + ni, "cpu")
    assert d.size == 15 and d.radixes == (5, 3)
    z_mont = _t(encode(z, d.spec))
    h = witness_map_device(d.spec, d, encode_matrices(m, d.spec, "cpu"), z_mont, ni, nc)
    assert decode(h.numpy(), d.spec) == LibsnarkReduction.witness_map_from_matrices(m, F181, ni, nc, z)


def test_mnt6_mixed_domain_beyond_two_adicity():
    """MNT6-298's Fr at 2^17 + 1 coefficients: the domain of 143,360 =
    2^12 * 35 (RefDomain's, radixes 7 and 5), its fft at four sampled
    points equal to a direct evaluation of the polynomial."""
    fr = get_curve("mnt6_298").fr
    d, rd = NttDomain(fr, (1 << 17) + 1, "cpu"), RefDomain(fr, (1 << 17) + 1)
    assert (d.size, d.group_gen, d.radixes) == (rd.size, rd.group_gen, (7, 5)) and d.size == 143360
    rng = np.random.default_rng(17)
    coeffs = [int(x) for x in rng.integers(0, 1 << 62, d.size)]
    got = d.fft(_t(encode(coeffs, d.spec)))
    p = fr.modulus
    for i in (0, 1, 4097, 143359):
        x, acc = pow(d.group_gen, i, p), 0
        for cf in reversed(coeffs):
            acc = (acc * x + cf) % p
        assert decode(got[:, i : i + 1].numpy(), d.spec) == [acc], i
