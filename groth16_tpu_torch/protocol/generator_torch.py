"""Trusted setup with the key scalars and the fixed-base batch muls on the
device (PyTorch).

Port of `groth16_tpu/protocol/generator_tpu.py`, which mirrors
generate_parameters_with_qap (generator.rs:47-208) with both hot sides on
the device:

* the QAP instance map -- Lagrange evaluation and the per-variable sparse
  accumulation (r1cs_to_qap.rs:128-170) -- with the gamma_abc / l key
  scalar maps (generator.rs:113-123) and the h-query powers
  (r1cs_to_qap.rs:237-247), via qap/device.instance_map_device (K1 for
  every product);
* the ~5 G1 and 1 G2 fixed-base batch multiplications (generator.rs:
  129-183), each a window-table lookup and one point addition per window
  over the whole batch (msm/fixed_base.py; K4 / K5 on the card).

Domains that are not radix-2, or a reduction other than
LibsnarkReduction, keep the exact host instance map.  The RNG is drawn in
the order of the exact `protocol.generator.setup`, so for the same Rng the
two give the same key.  Entry points run on the card unless the caller
passes device="cpu".
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from groth16_tpu_torch.config import resolve_device
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import encode, make_spec
from groth16_tpu_torch.msm.fixed_base import batch_mul_device, build_window_table, window_bases
from groth16_tpu_torch.ntt.ntt import NttDomain, powers, powers_device
from groth16_tpu_torch.protocol.data_structures import ProvingKey, VerifyingKey
from groth16_tpu_torch.qap.device import encode_matrix_transposed, instance_map_device
from groth16_tpu_torch.qap.reduction import LibsnarkReduction
from groth16_tpu_torch.r1cs.system import ConstraintSystem, SynthesisError, SynthesisMode
from groth16_tpu_torch.ref.curve import RefGroups
from groth16_tpu_torch.ref.domain import RefDomain
from groth16_tpu_torch.utils import profiling
from groth16_tpu_torch.utils.rng import Rng


def _window_bits(num_scalars: int) -> int:
    # table build costs 2*2^c adds/window; lookups cost 1 add/scalar/window
    best, best_cost = 4, None
    for c in range(4, 15):
        cost = (num_scalars + 2 * (1 << c)) / c
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def _device_setup_scalars(
    c, fr_spec, ndom, matrices, t,
    alpha, beta, gamma, delta, gamma_inv, delta_inv, num_instance,
):
    """Every key scalar of the setup, built on the device of `ndom`: the
    instance map (qap/device.instance_map_device), the gamma_abc / l maps
    (generator.rs:113-123: (beta*a_i + alpha*b_i + c_i) * gamma^-1 resp.
    delta^-1) and the h-query powers Z(t)*delta^-1*t^i
    (r1cs_to_qap.rs:237-247), as ONE standard-form scalar tensor per group.

    Returns (n_hint, counts, g1_std, g2_std) with counts = (len a, len b,
    len h, len l, len gamma_abc), the G1 tensor laid out
    [a | b | h | l | gamma_abc | alpha beta delta] and the G2 tensor
    [b | beta gamma delta] (generator.rs:129-183 order)."""
    r = c.r
    dev = ndom.device
    num_vars = num_instance + matrices.num_witness_variables
    mats_t = {
        k: encode_matrix_transposed(v, fr_spec, num_vars, dev)
        for k, v in matrices.flatten().items()
    }
    n = ndom.size
    zt = (pow(t, n, r) - 1) % r
    zt_dinv = zt * delta_inv % r
    xs = powers(fr_spec, ndom.group_gen, n, dev)
    a, b, cc = instance_map_device(
        fr_spec, ndom, mats_t, t, num_instance, matrices.num_constraints, xs
    )
    s = fp.add_strict(
        fr_spec,
        fp.add_strict(fr_spec, fp.mul_const(fr_spec, a, beta), fp.mul_const(fr_spec, b, alpha)),
        cc,
    )
    gabc = fp.mul_const(fr_spec, s[:, :num_instance], gamma_inv)
    l_s = fp.mul_const(fr_spec, s[:, num_instance:], delta_inv)
    # t^i table by log-doubling (power-of-two length), cut to n - 1
    h = fp.mul_const(fr_spec, powers_device(fr_spec, t, n, dev)[:, : n - 1], zt_dinv)
    g1_std = fp.from_mont(fr_spec, torch.cat([a, b, h, l_s, gabc], dim=1))
    b_std = g1_std[:, num_vars : 2 * num_vars]

    def std(values):
        return torch.from_numpy(encode(values, fr_spec, mont=False).astype("int32")).to(dev)

    g1_std = torch.cat([g1_std, std([alpha, beta, delta])], dim=1)
    g2_std = torch.cat([b_std, std([beta, gamma, delta])], dim=1)
    counts = (num_vars, num_vars, n - 1, num_vars - num_instance, num_instance)
    return num_vars, counts, g1_std, g2_std


def _host_setup_scalars(
    qap, fr, fr_spec, matrices, t,
    alpha, beta, gamma, delta, gamma_inv, delta_inv, num_instance, dev,
):
    """The key scalars of _device_setup_scalars, in its layout, from the
    exact instance map of `qap` on the host (any domain, any reduction),
    uploaded to `dev`."""
    r = fr_spec.modulus
    a, b, c_evals, zt, qap_num_variables, m_raw = qap.instance_map_with_evaluation(
        matrices, fr, t
    )
    s = [(beta * a[i] + alpha * b[i] + c_evals[i]) % r for i in range(qap_num_variables + 1)]
    gamma_abc = [x * gamma_inv % r for x in s[:num_instance]]
    l_scalars = [x * delta_inv % r for x in s[num_instance:]]
    h_scalars = qap.h_query_scalars(m_raw - 1, t, zt, delta_inv, fr)
    g1_std = codec.scalars_to_device(
        list(a) + list(b) + list(h_scalars) + l_scalars + gamma_abc + [alpha, beta, delta], fr_spec, dev
    )
    g2_std = codec.scalars_to_device(list(b) + [beta, gamma, delta], fr_spec, dev)
    counts = (len(a), len(b), len(h_scalars), len(l_scalars), len(gamma_abc))
    return len(a), counts, g1_std, g2_std


def generate_parameters_with_qap_device(
    circuit: Callable,
    curve: str,
    alpha: int,
    beta: int,
    gamma: int,
    delta: int,
    g1_generator,
    g2_generator,
    rng: Rng,
    qap=LibsnarkReduction,
    device="cuda",
    timer=None,
    record: Optional[dict] = None,
) -> ProvingKey:
    """generate_parameters_with_qap on the device.  timer: optional
    utils.profiling.PhaseTimer, which then times the phases synthesis,
    scalars, tables, batch_mul and decode.  record: optional dict that
    receives what the batch muls took -- the standard-form key scalars
    ("g1", "g2": int32 [Ls, n] tensors on the device, laid out as
    _device_setup_scalars says; "counts") and the bases ("g1_generator",
    "g2_generator") -- so a caller can recompute any key point."""
    dev = resolve_device(device)
    c = get_curve(curve)
    r = c.r
    fr = c.fr
    fr_spec = make_spec(r, name=f"{curve}.Fr")

    with profiling.span("synthesis", timer):
        cs = ConstraintSystem(r, mode=SynthesisMode.SETUP)
        circuit(cs)
        matrices = cs.to_matrices()
        domain = RefDomain(fr, cs.num_constraints + cs.num_instance_variables)
        t = domain.sample_element_outside_domain(rng)

    if gamma % r == 0 or delta % r == 0:
        raise SynthesisError(SynthesisError.Kind.UNEXPECTED_IDENTITY)
    gamma_inv = pow(gamma, r - 2, r)
    delta_inv = pow(delta, r - 2, r)
    num_instance = cs.num_instance_variables
    bits = r.bit_length()
    g1 = codec.g1_ops(c)
    g2 = codec.g2_ops(c)

    log_n = domain.size.bit_length() - 1
    # the device Lagrange identity holds on radix-2 domains only
    device_qap = qap is LibsnarkReduction and domain.size == 1 << log_n and log_n <= fr.two_adicity
    with profiling.span("scalars", timer):
        if device_qap:
            ndom = NttDomain(fr, cs.num_constraints + num_instance, dev)
            n_scalars, counts, g1_std, g2_std = _device_setup_scalars(
                c, fr_spec, ndom, matrices, t,
                alpha, beta, gamma, delta, gamma_inv, delta_inv, num_instance,
            )
        else:
            n_scalars, counts, g1_std, g2_std = _host_setup_scalars(
                qap, fr, fr_spec, matrices, t,
                alpha, beta, gamma, delta, gamma_inv, delta_inv, num_instance, dev,
            )
    if record is not None:
        record.update(
            g1=g1_std, g2=g2_std, counts=counts, g1_generator=g1_generator, g2_generator=g2_generator
        )

    # one window table per group; the JAX package pads every batch to a
    # power of two so that a setup compiles one program shape per group,
    # while PyTorch compiles nothing per shape, so batches run at their
    # own length
    cw = _window_bits(max(n_scalars, 1))
    num_windows = -(-bits // cw)
    with profiling.span("tables", timer):
        groups = RefGroups(curve)
        table_g1 = build_window_table(
            g1, codec.g1_to_device(c, window_bases(groups.g1_add, g1_generator, cw, num_windows), dev), cw
        )
        table_g2 = build_window_table(
            g2, codec.g2_to_device(c, window_bases(groups.g2_add, g2_generator, cw, num_windows), dev), cw
        )
    # ONE G1 call and ONE G2 call cover every query (generator.rs:129-183's
    # six batch_muls share the generators)
    with profiling.span("batch_mul", timer):
        g1_dev = batch_mul_device(g1, table_g1, g1_std, cw, bits)
        g2_dev = batch_mul_device(g2, table_g2, g2_std, cw, bits)
    with profiling.span("decode", timer):
        g1_pts = codec.g1_from_device(c, g1, g1_dev)
        g2_pts = codec.g2_from_device(c, g2, g2_dev)
    del g1_dev, g2_dev

    ofs = 0

    def take(k):
        nonlocal ofs
        out = g1_pts[ofs : ofs + k]
        ofs += k
        return out

    na, nb, nh, nl, ni = counts
    a_query = take(na)
    b_g1_query = take(nb)
    h_query = take(nh)
    l_query = take(nl)
    gamma_abc_g1 = take(ni)
    sm1 = take(3)
    b_g2_query = g2_pts[:nb]
    sm2 = g2_pts[nb:]

    vk = VerifyingKey(
        curve=curve,
        alpha_g1=sm1[0],
        beta_g2=sm2[0],
        gamma_g2=sm2[1],
        delta_g2=sm2[2],
        gamma_abc_g1=gamma_abc_g1,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=sm1[1],
        delta_g1=sm1[2],
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
    )


def setup_device(
    circuit: Callable, curve: str, rng: Rng, qap=LibsnarkReduction, device="cuda",
    timer=None, record: Optional[dict] = None,
):
    """SNARK::circuit_specific_setup analog with device batch muls; the
    RNG order of protocol.generator.setup.  Returns (pk, vk)."""
    dev = resolve_device(device)
    c = get_curve(curve)
    r = c.r
    alpha = rng.field_element(r)
    beta = rng.field_element(r)
    gamma = rng.field_element(r)
    delta = rng.field_element(r)
    groups = RefGroups(curve)
    g1 = groups.g1_mul(groups.g1_sample(seed=rng.u64() % 1000 + 1), rng.nonzero_field_element(r))
    g2 = groups.g2_mul(groups.g2_sample(seed=rng.u64() % 1000 + 1), rng.nonzero_field_element(r))
    pk = generate_parameters_with_qap_device(
        circuit, curve, alpha, beta, gamma, delta, g1, g2, rng, qap=qap, device=dev,
        timer=timer, record=record,
    )
    return pk, pk.vk
