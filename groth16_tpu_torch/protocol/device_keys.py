"""Device-resident ProvingKey mirror (structure-of-arrays limb tensors).

Port of `groth16_tpu/protocol/device_keys.py`, with its two layouts of
the four G1 MSMs of a prove (a_query[1:], b_g1_query[1:], h_query,
l_query): "grouped" (the single-device prover's), stacked per padded
size class, so short lanes do not pad to the h_query length; and
"stacked" (the sharded prover's, par/prover_dp.py), one [4, n_pad]
stack.  query[0] entries (the constant-1 wire) are stored as single
points.  With `shard=(i, S)` a rank uploads only its i-th 1/S of the
stacked element axis and of b_g2_tail, each padded with infinity to a
multiple of S first: the query points are never held whole on one card.

`device_key_from_numpy` and `proving_key_from_reference` carry a key of
the JAX package across (its device leaves fetched as numpy, or its host
dataclass); they serve the parity tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from groth16_tpu_torch.config import resolve_device
from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.fields.spec import make_spec
from groth16_tpu_torch.msm.pippenger import _pad_size
from groth16_tpu_torch.ntt.ntt import NttDomain
from groth16_tpu_torch.protocol.data_structures import ProvingKey, VerifyingKey
from groth16_tpu_torch.qap.device import device_matrix_from_numpy, encode_matrices
from groth16_tpu_torch.r1cs.matrices import ConstraintMatrices

LEAF_FIELDS = (
    "b_g2_tail", "a0", "b10", "b20", "alpha_g1", "beta_g1", "delta_g1",
    "beta_g2", "delta_g2", "mats", "g1_groups",
)
STATIC_FIELDS = (
    "curve", "num_inputs", "num_constraints", "n_pad", "n_h", "n_aux",
    "g1_group_info", "nv_tail",
)


@dataclasses.dataclass
class DeviceProvingKey:
    b_g2_tail: Any  # G2 Point batch [nv-1]
    a0: Any  # single G1: a_query[0]
    b10: Any  # single G1: b_g1_query[0]
    b20: Any  # single G2: b_g2_query[0]
    alpha_g1: Any
    beta_g1: Any
    delta_g1: Any
    beta_g2: Any
    delta_g2: Any
    mats: Dict[str, Any]  # a/b/c -> DeviceMatrix
    g1_groups: Any  # tuple of G1 Point tuples, leaves [L, k_g, npad_g]
    curve: str
    num_inputs: int
    num_constraints: int
    n_pad: int  # max padded MSM length
    n_h: int  # len(h_query) = domain_size - 1
    n_aux: int  # len(l_query) = witness count
    # ((npad_g, (canonical lane ids...)), ...); canonical lane order is
    # 0=a_query[1:], 1=b_g1_query[1:], 2=h_query, 3=l_query
    g1_group_info: tuple
    nv_tail: int  # len(a_query) - 1 = rho length
    device: torch.device
    # "stacked" layout: [*coords, 4, n_pad] (this rank's n_pad / S with
    # a shard), lanes in canonical order; None in the grouped layout
    g1_msm_points: Any = None

    @property
    def params(self):
        return get_curve(self.curve)

    @property
    def fr_spec(self):
        return make_spec(self.params.r, name=f"{self.curve}.Fr")

    @property
    def domain(self) -> NttDomain:
        return NttDomain(self.params.fr, self.num_constraints + self.num_inputs, self.device)


def _pad_points(pt, n_pad, g):
    n = pt[2].shape[-1]
    if n == n_pad:
        return pt
    inf = g.infinity((n_pad - n,), device=pt[0].device)
    return tuple(torch.cat([a, b], dim=-1) for a, b in zip(pt, inf))


def group_lane_sizes(lengths) -> tuple:
    """Cluster MSM lane lengths into padded size classes: lanes whose
    padded length is within 4/3 of the running class pad share a class.
    Returns ((npad, (canonical lane ids...)), ...)."""
    order = sorted(range(len(lengths)), key=lambda i: _pad_size(lengths[i]))
    groups = []
    for i in order:
        p = _pad_size(lengths[i])
        if groups and p * 3 <= groups[-1][0] * 4:
            groups[-1] = (max(groups[-1][0], p), groups[-1][1] + (i,))
        else:
            groups.append((p, (i,)))
    return tuple(groups)


def upload_proving_key(
    pk: ProvingKey,
    matrices: ConstraintMatrices,
    device="cuda",
    pad_multiple: int = 1,
    layout: str = "grouped",
    shard=None,
) -> DeviceProvingKey:
    """layout: "grouped" (single-device prover; per-size-class G1 stacks so
    short lanes don't pad to the longest) or "stacked" (one [4, n_pad]
    stack, which the sharded prover's element sharding consumes; there
    b_g2_tail is padded with infinity to a multiple of pad_multiple).
    pad_multiple: round the stacked MSM length n_pad up (mesh
    divisibility).

    shard: (index, S), the sharded prover's key: the stacked layout with
    pad_multiple S, of which only the index-th 1/S of the element axis of
    the stack and of b_g2_tail is encoded and uploaded (layout and
    pad_multiple are then implied and left at their defaults).  The
    single points and the matrices are whole on every shard."""
    if layout not in ("grouped", "stacked"):
        raise ValueError(f"upload_proving_key: layout {layout!r}")
    if shard is not None:
        if (layout, pad_multiple) != ("grouped", 1):
            raise ValueError(f"upload_proving_key: shard {shard} sets the layout and pad_multiple itself")
        layout, pad_multiple = "stacked", shard[1]
    dev = resolve_device(device)
    c = get_curve(pk.vk.curve)
    fr = make_spec(c.r, name=f"{c.name}.Fr")
    g1 = codec.g1_ops(c)

    def single_g1(p):
        return tuple(a[..., 0] for a in codec.g1_to_device(c, [p], dev))

    def single_g2(p):
        return tuple(a[..., 0] for a in codec.g2_to_device(c, [p], dev))

    def part(pts, n_pad):
        """The shard's slice of pts padded with infinity (None) to n_pad."""
        index, count = shard if shard is not None else (0, 1)
        m = n_pad // count
        got = list(pts[index * m : (index + 1) * m])
        return got + [None] * (m - len(got))

    n_h = len(pk.h_query)
    n_aux = len(pk.l_query)
    nv_tail = len(pk.a_query) - 1
    n_pad = max(n_h, n_aux, nv_tail)
    n_pad = -(-n_pad // pad_multiple) * pad_multiple
    queries = [pk.a_query[1:], pk.b_g1_query[1:], pk.h_query, pk.l_query]
    groups, info, stacked = (), (), None
    b_g2_tail = pk.b_g2_query[1:]
    if layout == "grouped":
        info = group_lane_sizes([len(q) for q in queries])
        gs = []
        for npad_g, lane_ids in info:
            lanes_g = [
                _pad_points(codec.g1_to_device(c, queries[i], dev), npad_g, g1) for i in lane_ids
            ]
            gs.append(tuple(torch.stack([lane[k] for lane in lanes_g], dim=-2) for k in range(3)))
        groups = tuple(gs)
    else:
        lanes = [codec.g1_to_device(c, part(q, n_pad), dev) for q in queries]
        # lanes stacked just before the element axis: [*coords, 4, N] —
        # the layout msm_device_lanes consumes
        stacked = tuple(torch.stack([lane[k] for lane in lanes], dim=-2) for k in range(3))
        b_g2_tail = part(b_g2_tail, -(-nv_tail // pad_multiple) * pad_multiple)
    return DeviceProvingKey(
        b_g2_tail=codec.g2_to_device(c, b_g2_tail, dev),
        a0=single_g1(pk.a_query[0]),
        b10=single_g1(pk.b_g1_query[0]),
        b20=single_g2(pk.b_g2_query[0]),
        alpha_g1=single_g1(pk.vk.alpha_g1),
        beta_g1=single_g1(pk.beta_g1),
        delta_g1=single_g1(pk.delta_g1),
        beta_g2=single_g2(pk.vk.beta_g2),
        delta_g2=single_g2(pk.vk.delta_g2),
        mats=encode_matrices(matrices, fr, dev),
        g1_groups=groups,
        curve=pk.vk.curve,
        num_inputs=matrices.num_instance_variables,
        num_constraints=matrices.num_constraints,
        n_pad=n_pad,
        n_h=n_h,
        n_aux=n_aux,
        g1_group_info=info,
        nv_tail=nv_tail,
        device=dev,
        g1_msm_points=stacked,
    )


def device_key_from_numpy(leaves: Mapping, static: Mapping, device="cuda") -> DeviceProvingKey:
    """Build the port's DeviceProvingKey from the leaves of a JAX
    `DeviceProvingKey` (grouped layout) fetched as numpy arrays, plus its
    static fields.

    leaves: field name -> numpy structure, for every name in LEAF_FIELDS
    (points as tuples of uint32 digit arrays; `mats` as a/b/c -> mapping
    with coeffs, cols, seg_start, end_idx, nonempty, num_rows).  static:
    field name -> value for every name in STATIC_FIELDS."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)).to(dev)

    def pt(x):
        return tuple(t(a) for a in x)

    mats = {
        name: device_matrix_from_numpy(
            m["coeffs"], m["cols"], m["seg_start"], m["end_idx"], m["nonempty"],
            m["num_rows"], dev,
        )
        for name, m in leaves["mats"].items()
    }
    return DeviceProvingKey(
        **{f: pt(leaves[f]) for f in LEAF_FIELDS if f not in ("mats", "g1_groups")},
        mats=mats,
        g1_groups=tuple(pt(g) for g in leaves["g1_groups"]),
        **{f: static[f] for f in STATIC_FIELDS},
        device=dev,
    )


def proving_key_from_reference(pk) -> ProvingKey:
    """Copy a host ProvingKey of the JAX package, field by field, into
    this package's dataclass (points are immutable int tuples)."""
    vk = pk.vk
    return ProvingKey(
        vk=VerifyingKey(
            curve=vk.curve,
            alpha_g1=vk.alpha_g1,
            beta_g2=vk.beta_g2,
            gamma_g2=vk.gamma_g2,
            delta_g2=vk.delta_g2,
            gamma_abc_g1=list(vk.gamma_abc_g1),
        ),
        beta_g1=pk.beta_g1,
        delta_g1=pk.delta_g1,
        a_query=list(pk.a_query),
        b_g1_query=list(pk.b_g1_query),
        b_g2_query=list(pk.b_g2_query),
        h_query=list(pk.h_query),
        l_query=list(pk.l_query),
    )
