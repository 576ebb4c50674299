"""Rank meshes over `torch.distributed` (the rayon-thread-pool analog,
SURVEY.md §2.4).

Port of `groth16_tpu/par/mesh.py`.  The JAX package is single-controller:
one process holds a `jax.sharding.Mesh` of S devices and `shard_map`
runs the body on each.  The port runs one process a shard (SPMD): every
rank calls the same entry point with the same host inputs and returns the
same result.  A `Mesh` lays the ranks of the default process group out on
named axes; for each axis (and for the tuple of all of them) it holds the
process group of this rank's line along that axis, as `MeshAxis`, which
the collectives (`par/collectives.py`) take where the JAX package names
an axis inside `shard_map`.

Groups come from `dist.new_group`, which every rank of the default group
must call in the same order: so every rank builds every mesh, also one
that it is not a member of (`Mesh.member` is then False).  The backend is
the caller's choice (`run_ranks`): "nccl" where each rank has a card of
its own, "gloo" on the CPU and where ranks share one card; under gloo the
collectives carry CUDA tensors through host copies (`par/collectives.py`).

`run_ranks` starts the ranks; the JAX package needs no launcher, its
devices being virtual.  Its rank functions live in the package
(`par/dryrun.py`): a spawned child imports the module of the function it
runs, and a test module imports the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from groth16_tpu_torch.config import resolve_device

DATA_AXIS = "data"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class MeshAxis:
    """This rank's line along one axis (or a tuple of axes) of a mesh.

    names: the axis names; ranks: the global ranks of the line, in the
    order of its group ranks (ascending); index: this rank's place in it;
    group: the line's process group."""

    mesh: "Mesh"
    names: Tuple[str, ...]
    ranks: Tuple[int, ...]
    index: int
    group: object

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """The ranks `ranks` (an array whose shape is the mesh's) on the named
    axes `axis_names`, with this rank's device.  Built by every rank of the
    default group; ranks must ascend along every axis (row-major), so that
    a line's group ranks follow its axis.

    shape: axis name -> size (as `jax.sharding.Mesh.shape`); traffic:
    collective name -> {"calls", "bytes"} on this rank (the bytes each
    call hands to the backend; "host_copies": the device-to-host and
    host-to-device copies of the gloo transport)."""

    def __init__(self, ranks, axis_names: Sequence[str], device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: torch.distributed is not initialised (par.mesh.run_ranks)")
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"Mesh: {ranks.ndim}-D ranks for axes {axis_names}")
        flat = ranks.reshape(-1)
        if not np.all(np.diff(flat) > 0):
            raise ValueError(f"Mesh: ranks must ascend row-major, got {flat.tolist()}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.member = bool(np.any(flat == self.rank))
        self.traffic: Dict[str, Dict[str, int]] = collections.defaultdict(lambda: {"calls": 0, "bytes": 0})
        self._axes: Dict[Tuple[str, ...], MeshAxis] = {}
        keys = [(a,) for a in axis_names] + ([axis_names] if len(axis_names) > 1 else [])
        for key in keys:
            # lines along `key`: its axes last, the others fixed
            dims = [axis_names.index(a) for a in key]
            rest = [d for d in range(len(axis_names)) if d not in dims]
            lines = np.transpose(ranks, rest + dims).reshape(-1, int(np.prod([ranks.shape[d] for d in dims])))
            for line in lines.tolist():
                group = dist.new_group(line)
                if self.rank in line:
                    self._axes[key] = MeshAxis(self, key, tuple(line), line.index(self.rank), group)

    def axis(self, axis) -> MeshAxis:
        """This rank's line along `axis`: a name, or a tuple of names (all
        the mesh's axes in its order, or one)."""
        key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if not self.member:
            raise ValueError(f"Mesh: rank {self.rank} is not in the mesh {self.ranks.tolist()}")
        if key not in self._axes:
            raise ValueError(f"Mesh: no axis {key} among {self.axis_names}")
        return self._axes[key]

    def count(self, name: str, nbytes: int) -> None:
        t = self.traffic[name]
        t["calls"] += 1
        t["bytes"] += int(nbytes)

    def traffic_summary(self) -> Dict[str, Dict[str, int]]:
        return {k: dict(v) for k, v in self.traffic.items()}


def axis_size(mesh: Mesh, axis) -> int:
    """Ranks along `axis` — a name or a tuple of names (a 2D host×chip
    mesh passes axis=("host", "chip") to shard the element axis across the
    combined extent, host-major)."""
    if isinstance(axis, (tuple, list)):
        s = 1
        for a in axis:
            s *= mesh.shape[a]
        return s
    return mesh.shape[axis]


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, device="cuda") -> Mesh:
    """1D mesh over the first `n_devices` ranks (all by default); every
    rank of the default group calls it.  device: this rank's device."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return Mesh(np.arange(n), (axis,), device)


def make_mesh_2d(
    n_hosts: int,
    chips_per_host: int,
    axes: tuple = ("host", "chip"),
    device="cuda",
) -> Mesh:
    """Multi-host mesh (BASELINE config 5): outer axis = hosts, inner
    axis = chips within a host.  Passing axis=axes to
    ShardedProver/ShardedNtt shards elements over all
    n_hosts * chips_per_host ranks, on the group of both axes."""
    return Mesh(np.arange(n_hosts * chips_per_host).reshape(n_hosts, chips_per_host), axes, device)


def _tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    raise TypeError(f"not a tensor tree: {type(x)}")


def shard_elements(mesh: Mesh, x, axis=DATA_AXIS):
    """This rank's contiguous slice of the trailing element axis of each
    leaf of `x` (a tensor, or tuples, lists and dicts of them), on the
    mesh's device (the fields/fp.py convention: batch axes trail)."""
    ax = mesh.axis(axis)

    def put(a):
        n = a.shape[-1]
        if n % ax.size:
            raise ValueError(f"shard_elements: {n} elements over {ax.size} ranks")
        m = n // ax.size
        return a[..., ax.index * m : (ax.index + 1) * m].contiguous().to(mesh.device)

    return _tree_map(put, x)


def replicated(mesh: Mesh, x):
    """Every leaf whole on this rank's device."""
    return _tree_map(lambda a: a.to(mesh.device), x)


# -- launcher ---------------------------------------------------------------------


def _rank_main(rank, world_size, backend, device, tmp, fn, args):
    dev = resolve_device(device)
    if dev.type == "cuda":
        # ranks share the cards round robin (only gloo takes two on one)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # a test's ranks share the CPU with other tests
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank, world_size=world_size
    )
    try:
        out = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def run_ranks(fn, world_size: int, backend: str, device, *args, timeout_s: Optional[float] = None) -> list:
    """Run `fn(rank_device, *args)` in `world_size` spawned processes,
    one rank each, over `backend`, and return their results by rank.

    fn must be a module-level function of this package (a child imports
    its module) and return something picklable; args are pickled to each
    child.  The rendezvous is a file in a fresh temporary directory, so
    several launches may run at once.  backend "nccl" needs a card for
    every rank and raises otherwise; "gloo" runs on the CPU, or with
    ranks sharing cards.  An exception in a rank ends every rank and is
    raised here; so does a launch still running after timeout_s seconds
    (TimeoutError), whose ranks are ended."""
    if backend not in BACKENDS:
        raise ValueError(f"run_ranks: backend {backend!r} is not one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl" and (dev.type != "cuda" or world_size > torch.cuda.device_count()):
        raise ValueError(
            f"run_ranks: nccl takes one card a rank; {world_size} ranks on {dev} "
            f"with {torch.cuda.device_count()} cards"
        )
    with tempfile.TemporaryDirectory(prefix="g16_ranks_") as tmp:
        ctx = mp.spawn(
            _rank_main, args=(world_size, backend, str(dev), tmp, fn, args), nprocs=world_size, join=False
        )
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"run_ranks: {fn.__name__} still running after {timeout_s} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))  # written by this launch's own ranks
    return out
