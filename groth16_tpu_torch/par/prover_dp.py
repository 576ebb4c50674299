"""Multi-device Groth16 prover: sharded witness map + sharded MSMs.

Port of `groth16_tpu/par/prover_dp.py` (SURVEY.md §2.4) onto
`torch.distributed`, one process a shard (par/mesh.py):
  - the NTT pipeline (7 transforms) through the four-step all-to-all
    ShardedNtt (par/ntt_cp.py) on coefficient vectors sharded over the
    mesh axis;
  - the four G1 MSMs as one lane-batched Pippenger on this rank's slice
    of the stacked key, then an all_gather of the S partials and a
    log2(S) tree combine (par/collectives.py; K4 on the card);
  - the G2 MSM the same way (K5);
  - the O(1) assembly replicated: every rank runs the device assembly
    (prover_torch.assembly_phase) and decodes the same proof.

The sparse witness evaluation (O(nnz) field ops) stays replicated — it
is two orders of magnitude lighter than the NTTs/MSMs it feeds
(SURVEY.md §3.2 hot-loop table).  Each rank uploads only its slice of
the query points (`upload_proving_key(..., shard=...)`).  The JAX file's
per-op `jit_with_static` programs only manage XLA compiles; PyTorch runs
eagerly, so they have no counterpart here (as utils/jitcache.py has
none).
"""

from __future__ import annotations

from typing import List

import torch

from groth16_tpu_torch.curves import codec
from groth16_tpu_torch.curves.params import get_curve
from groth16_tpu_torch.curves.point import CurveDevice, Point
from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import make_spec
from groth16_tpu_torch.msm.pippenger import msm_device_lanes
from groth16_tpu_torch.par.collectives import all_gather_leaves, gather_tree_reduce
from groth16_tpu_torch.par.mesh import DATA_AXIS, axis_size, make_mesh
from groth16_tpu_torch.par.ntt_cp import ShardedNtt
from groth16_tpu_torch.protocol.data_structures import Proof, ProvingKey
from groth16_tpu_torch.protocol.device_keys import DeviceProvingKey, upload_proving_key
from groth16_tpu_torch.protocol.prover_torch import (
    assembly_phase,
    decode_proof_arrays,
    encode_assignment,
    scalar_bits,
)
from groth16_tpu_torch.qap.device import rows_window, witness_map_device
from groth16_tpu_torch.r1cs.matrices import ConstraintMatrices
from groth16_tpu_torch.utils import profiling


def msm_sharded_lanes(
    g: CurveDevice,
    points: Point,  # this rank's slice: leaves [*coords, lanes, N/S]
    scalars: torch.Tensor,  # this rank's slice: [lanes, Ls, N/S]
    scalar_bits: int,
    mesh,
    axis=DATA_AXIS,
    window_bits: int | None = None,
) -> Point:
    """Lane-batched MSM over a sharded point axis; returns points with
    batch (lanes,), the same on every rank.  One local lane-batched
    Pippenger a rank (its window chosen for N/S points), then an
    all_gather of the S partials and a log2(S) halving combine."""
    acc = msm_device_lanes(g, points, scalars, scalar_bits, window_bits)
    return gather_tree_reduce(g.add, acc, mesh.axis(axis))  # [*coords, lanes]


def witness_map_sharded(spec, sntt: ShardedNtt, mats, z_mont, num_inputs, num_constraints, mesh, axis=DATA_AXIS):
    """Sharded witness map (r1cs_to_qap.rs:172-235): witness_map_device on
    this rank's rows of the transforms.  -> this rank's slice of h,
    [L, n/S] Montgomery."""
    ax = mesh.axis(axis)
    m = sntt.size // ax.size
    return witness_map_device(spec, sntt, mats, z_mont, num_inputs, num_constraints, (ax.index * m, m))


def _g1_scalar_stack(fr, sntt: ShardedNtt, mesh, axis, dpk: DeviceProvingKey, z_mont, num_inputs):
    """Witness map + standard-form scalar prep for the 4-lane G1 MSM
    (prover.rs:63-113 scalar assembly).  Returns (scalars4: this rank's
    [4, Ls, n_pad/S], rho_std: [Ls, nv_tail], whole).  The NTT's shards
    of h need not be the lane's (n_pad may differ from n), so h is
    gathered whole first: one all_gather of n elements."""
    ax = mesh.axis(axis)
    h_mont = witness_map_sharded(fr, sntt, dpk.mats, z_mont, num_inputs, dpk.num_constraints, mesh, axis)
    (h_std,) = all_gather_leaves([fp.from_mont(fr, h_mont)], ax, "gather_h")  # [S, Ls, n/S]
    h_std = h_std.movedim(0, 1).reshape(h_std.shape[1], -1)
    z_std = fp.from_mont(fr, z_mont)
    rho_std = z_std[:, 1:]
    aux_std = z_std[:, num_inputs:]
    m = dpk.n_pad // ax.size
    lo = ax.index * m
    scalars4 = torch.stack(
        [
            rows_window(rho_std, lo, lo + m),
            rows_window(rho_std, lo, lo + m),
            rows_window(h_std[:, : dpk.n_h], lo, lo + m),
            rows_window(aux_std[:, : dpk.n_aux], lo, lo + m),
        ],
        dim=0,
    )
    return scalars4, rho_std


def _msm_g2(dpk: DeviceProvingKey, rho_std, mesh, axis) -> Point:
    """G2 MSM (b_g2_query tail): a single lane over this rank's slice of
    the tail, padded at upload to a shardable length."""
    c = dpk.params
    ax = mesh.axis(axis)
    m = dpk.b_g2_tail[2].shape[-1]
    sc = rows_window(rho_std, ax.index * m, (ax.index + 1) * m)
    acc = msm_sharded_lanes(
        codec.g2_ops(c), tuple(x[..., None, :] for x in dpk.b_g2_tail), sc[None], c.r.bit_length(), mesh, axis
    )
    return tuple(x[..., 0] for x in acc)


class ShardedProver:
    """Multi-device prover over a mesh axis (SURVEY.md §2.4 msm_dp+ntt_cp).

    Every rank of the mesh constructs it and calls `prove` with the same
    arguments; each gets the same Proof.  The rank uploads only its slice
    of the stacked query points (`dpk`).  device: the rank's device when
    mesh is None (a mesh carries its own)."""

    def __init__(self, pk: ProvingKey, matrices: ConstraintMatrices, mesh=None, axis=DATA_AXIS, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.axis = axis
        self.ax = self.mesh.axis(axis)
        self.device = self.mesh.device
        self.curve = pk.vk.curve
        self.c = get_curve(self.curve)
        self.fr = make_spec(self.c.r, name=f"{self.curve}.Fr")
        S = axis_size(self.mesh, axis)
        self.dpk = upload_proving_key(pk, matrices, self.device, shard=(self.ax.index, S))
        self.sntt = ShardedNtt(self.dpk.domain, self.mesh, axis)

    def encode_assignment(self, full_assignment: List[int]) -> torch.Tensor:
        return encode_assignment(self.fr, full_assignment, self.device)

    def prove(self, full_assignment: List[int], r: int, s: int, timer=None) -> Proof:
        """The sharded prove, assembled on this rank's device.  timer:
        optional utils.profiling.PhaseTimer (phases as TorchProver's)."""
        dpk, c = self.dpk, self.c
        rr = c.r
        r %= rr
        s %= rr
        z_mont = self.encode_assignment(full_assignment)
        with profiling.span("witness_map", timer):
            scalars4, rho_std = _g1_scalar_stack(
                self.fr, self.sntt, self.mesh, self.axis, dpk, z_mont, dpk.num_inputs
            )
        with profiling.span("msm_g1_x4", timer):
            acc4 = msm_sharded_lanes(
                codec.g1_ops(c), dpk.g1_msm_points, scalars4, rr.bit_length(), self.mesh, self.axis
            )
        with profiling.span("msm_g2", timer):
            b2_acc = _msm_g2(dpk, rho_std, self.mesh, self.axis)
        with profiling.span("assembly", timer):
            out = assembly_phase(dpk, acc4, b2_acc, scalar_bits([r, s, r * s % rr], self.device))
        return decode_proof_arrays(self.curve, out)
