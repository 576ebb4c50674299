"""Communication backend: the named collective layer over
`torch.distributed`.

Port of `groth16_tpu/par/collectives.py` (SURVEY.md §2.4 and §5.8).
Each collective takes a `MeshAxis` (`Mesh.axis(name)`, par/mesh.py)
where the JAX package names an axis inside `shard_map`, and runs on that
axis's process group:

  - `transpose_a2a`      — all_to_all block transpose (the four-step NTT's
                           only communication; par/ntt_cp.py)
  - `gather_tree_reduce` — all_gather of per-rank partials + log2(S)
                           halving combine under a point-add monoid (the
                           sharded Pippenger lane reduction, par/prover_dp.py;
                           K4/K5 on the card)
  - `psum_field`         — field-vector psum: int32 digit sum over the axis
                           + one value reduction (bounded fan-in)
  - `ring_shift`         — a ring step of point-to-point sends
  - `all_gather_leaves`  — the all_gather under gather_tree_reduce, also
                           used whole (h, checksums, a batch's proofs)

Transport: under "nccl" the tensors go to the backend where they lie.
Under "gloo", which carries CUDA tensors for few of these collectives, a
CUDA tensor is copied to the host (one device-to-host copy), the
collective runs there, and its result is copied back (one host-to-device
copy): the transport is chosen by the backend's name, not by catching an
error, and all arithmetic stays on the card.  Every call counts the bytes
it hands to the backend, and the gloo transport its copies
(`Mesh.traffic`, under the collective's name and "host_copies").

Layouts are limb-major (int32[L, ..., n]); every tensor returned is
contiguous (the kernels' wrappers refuse other strides on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from groth16_tpu_torch.fields import fp
from groth16_tpu_torch.fields.spec import FpSpec
from groth16_tpu_torch.par.mesh import MeshAxis


def _send(x: torch.Tensor, axis: MeshAxis, name: str) -> torch.Tensor:
    """x as the backend takes it: contiguous, on the host under gloo."""
    mesh = axis.mesh
    x = x.contiguous()
    mesh.count(name, x.numel() * x.element_size())
    if mesh.backend == "gloo" and x.is_cuda:
        mesh.count("host_copies", x.numel() * x.element_size())
        return x.cpu()
    return x


def _recv(y: torch.Tensor, device: torch.device, axis: MeshAxis) -> torch.Tensor:
    if y.device != device:
        axis.mesh.count("host_copies", y.numel() * y.element_size())
        return y.to(device)
    return y


def transpose_a2a(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Global [L, R, C] (R sharded on `axis`) -> [L, C, R] (C sharded):
    one all_to_all of S blocks and a local block transpose.  Local view:
    [L, R/S, C] -> [L, C/S, R].  At S = 1 only the local transpose runs
    (no collective, nothing counted)."""
    S = axis.size
    L, r, C = x.shape
    if C % S:
        raise ValueError(f"transpose_a2a: {C} columns over {S} ranks")
    if S == 1:
        return x.transpose(1, 2).contiguous()
    blocks = x.reshape(L, r, S, C // S).permute(2, 0, 1, 3)  # [S (to), L, R/S, C/S]
    send = _send(blocks, axis, "transpose_a2a")
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=axis.group)
    got = _recv(got, x.device, axis)  # [S (from), L, R/S, C/S]
    return got.permute(1, 3, 0, 2).reshape(L, C // S, S * r).contiguous()


def all_gather_leaves(leaves, axis: MeshAxis, name: str = "all_gather") -> tuple:
    """Every rank's copy of each leaf (int32 or bool tensors of any
    shape): -> tuple of [S, *shape] tensors, rank order, in one
    all_gather of the leaves packed into one int32 buffer."""
    leaves = tuple(leaves)
    S = axis.size
    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in leaves])
    send = _send(flat, axis, name)
    got = torch.empty((S, flat.numel()), dtype=torch.int32, device=send.device)
    dist.all_gather(list(got.unbind(0)), send, group=axis.group)
    got = _recv(got, leaves[0].device, axis)
    out, off = [], 0
    for x in leaves:
        part = got[:, off : off + x.numel()].reshape((S,) + tuple(x.shape))
        out.append(part.to(x.dtype).contiguous())
        off += x.numel()
    return tuple(out)


def gather_tree_reduce(add_fn, leaves, axis: MeshAxis):
    """all_gather each leaf's per-rank partial to a trailing batch axis,
    then combine the S partials with log2(S) halving `add_fn` steps.

    add_fn(a, b): leafwise monoid (e.g. CurveDevice.add over point
    tuples).  leaves: tuple of tensors (one partial per rank, any shape).
    Returns the reduced leaves (the same on every rank).  S must be a
    power of two: the halving drops nothing only then.  At S = 1 it is
    the identity and launches nothing."""
    S = axis.size
    if S & (S - 1):
        raise ValueError(f"gather_tree_reduce: {S} ranks is not a power of two")
    red = tuple(x.movedim(0, -1).contiguous() for x in all_gather_leaves(leaves, axis, "gather_tree_reduce"))
    m = S
    while m > 1:
        h = m // 2
        red = add_fn(
            tuple(x[..., :h].contiguous() for x in red),
            tuple(x[..., h:m].contiguous() for x in red),
        )
        m = h
    return tuple(x[..., 0] for x in red)


def psum_field(spec: FpSpec, x: torch.Tensor, axis: MeshAxis, size: int) -> torch.Tensor:
    """Field-vector psum over a mesh axis: int32 digit-wise all_reduce,
    then one value reduction.  `size` = the axis size S.  Safe for
    S <= 128: S inputs < 2p (exact digits < 2^15, as K1 returns them) sum
    to < 2Sp <= 2^8 p, and their digits to < S 2^15 <= 2^22, well inside
    int32."""
    if size != axis.size:
        raise ValueError(f"psum_field: size {size} on an axis of {axis.size}")
    s = _send(x.clone(), axis, "psum_field")
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=axis.group)
    return fp.reduce_to_2p(spec, _recv(s, x.device, axis), bound_k=2 * size)


def ring_shift(x: torch.Tensor, axis: MeshAxis, size: int, offset: int = 1) -> torch.Tensor:
    """Ring step: rank i's block moves to rank (i + offset) % S (the
    JAX package's ppermute).  `size` = the axis size S."""
    if size != axis.size:
        raise ValueError(f"ring_shift: size {size} on an axis of {axis.size}")
    if offset % size == 0:
        return x.clone()
    i = axis.index
    send = _send(x, axis, "ring_shift")
    got = torch.empty_like(send)
    ops = [
        dist.P2POp(dist.isend, send, axis.ranks[(i + offset) % size], axis.group),
        dist.P2POp(dist.irecv, got, axis.ranks[(i - offset) % size], axis.group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _recv(got, x.device, axis)


def all_reduce_max(value: int, axis: MeshAxis) -> int:
    """The largest of every rank's `value` (a small int), on every rank."""
    t = torch.tensor([value], dtype=torch.int32, device=axis.mesh.device)
    s = _send(t, axis, "all_reduce_max")
    dist.all_reduce(s, op=dist.ReduceOp.MAX, group=axis.group)
    return int(s.item())
