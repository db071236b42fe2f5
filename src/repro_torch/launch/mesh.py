"""Device meshes of the port over `torch.distributed`.

Counterpart of `repro.launch.mesh`: a `Mesh` names its axes, ("data",
"model") or ("pod", "data", "model") for the reference's multi-pod case,
and lays the ranks out row-major over them, so rank = (pod * D + data) * M
+ model. One process runs each rank (started by `torchrun` or
`torch.multiprocessing`); a world of 1 starts itself.

The sharded backend reduces over three kinds of groups: the data-like
axes (the ranks that share a model column), the model axis (the ranks that
share a data row), and all ranks. `Mesh.psum` / `Mesh.pmax` take the axes
by name. A reduction over axes of total size 1 is the identity and issues
no collective, as XLA compiles a psum over a size-1 axis to nothing;
`Mesh.counts` tells the reductions asked for from the collectives issued.

Devices and backends. Each rank runs on `cuda:LOCAL_RANK` when the host
has a card for every local rank, else on the one card; `device="cpu"`
keeps every rank on the CPU. NCCL will not put two ranks on one card, so
the process group is NCCL when each rank has a card of its own (a world
of 1 included), gloo (with CUDA tensors) when ranks share the card, and
gloo on the CPU. The choice follows the layout, is printed, and is never
made after a failure: a group that does not come up raises.
"""
from __future__ import annotations

import atexit
import itertools
import os
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

Tensor = torch.Tensor


def _local_layout() -> Tuple[int, int]:
    """(local rank, local world size) from torchrun's variables, or the
    global ones when the ranks were started otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    return (int(os.environ.get("LOCAL_RANK", str(rank))),
            int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def placement(device="cuda") -> Tuple[torch.device, str]:
    """(this rank's device, the process-group backend) for the layout
    the environment describes; see the module docstring."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    local_rank, local_world = _local_layout()
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def init_distributed(device="cuda") -> str:
    """Start the default process group if none is running: from torchrun's
    environment (`env://`) when WORLD_SIZE is set, else as a world of 1 on
    an in-process store. Returns the group's backend."""
    if dist.is_initialized():
        return dist.get_backend()
    dev, backend = placement(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        # torn down before the interpreter is: left to interpreter exit,
        # a rank that ends first could abort in the group's teardown
        # (SIGABRT, "terminate called without an active exception") while
        # another still wrote its report, and torchrun failed the run
        atexit.register(_destroy_group)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return backend


def _destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """Named axes over the ranks of the default process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        shape = tuple(int(a) for a in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axes {names} differ")
        if any(a < 1 for a in shape):
            raise ValueError(f"mesh shape {shape}: every axis must be >= 1")
        need = 1
        for a in shape:
            need *= a
        backend = init_distributed(device)
        world = dist.get_world_size()
        if world != need:
            raise ValueError(
                f"mesh {dict(zip(names, shape))} needs {need} ranks, the "
                f"process group has {world}; start {need} ranks (torchrun "
                f"--nproc-per-node {need}) or change the mesh")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.rank = dist.get_rank()
        self.world = world
        self.backend = backend
        self.device, _ = placement(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        strides, acc = {}, 1
        for name in reversed(names):
            strides[name] = acc
            acc *= self.shape[name]
        self._strides = strides
        self.coords = {a: (self.rank // strides[a]) % self.shape[a]
                       for a in names}
        self._groups: Dict[Tuple[str, ...], object] = {}
        # every subset of axes of size > 1 gets its groups, created in the
        # same order on every rank (new_group is collective)
        for k in range(1, len(names)):
            for sub in itertools.combinations(names, k):
                if self.size(sub) == 1:
                    continue
                rest = [a for a in names if a not in sub]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = [self._rank_of({**dict(zip(rest, fixed)),
                                            **dict(zip(sub, c))})
                             for c in itertools.product(
                                 *(range(self.shape[a]) for a in sub))]
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = group
        self.counts = {"asked": 0, "issued": 0}

    def _rank_of(self, coords: dict) -> int:
        return sum(coords[a] * self._strides[a] for a in self.axis_names)

    def describe(self) -> str:
        axes = " x ".join(f"{a}={self.shape[a]}" for a in self.axis_names)
        return (f"{axes} world={self.world} rank={self.rank} "
                f"backend={self.backend} device={self.device}")

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r} "
                               f"(axes {self.axis_names})")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        out = 1
        for a in self._axes(axes):
            out *= self.shape[a]
        return out

    def index(self, axes) -> int:
        """This rank's row-major index over `axes` (e.g. its data shard
        over ("pod", "data"))."""
        out = 0
        for a in self._axes(axes):
            out = out * self.shape[a] + self.coords[a]
        return out

    def _group(self, axes: Tuple[str, ...]):
        if len(axes) == len(self.axis_names):
            return None                       # the default group
        return self._groups[axes]

    def _reduce(self, t: Tensor, axes, op) -> Tensor:
        axes = self._axes(axes)
        self.counts["asked"] += 1
        if self.size(axes) == 1:
            return t
        self.counts["issued"] += 1
        dist.all_reduce(t, op=op, group=self._group(axes))
        return t

    def psum(self, t: Tensor, axes) -> Tensor:
        """Sum of `t` over the ranks along `axes`, IN PLACE (returned)."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: Tensor, axes) -> Tensor:
        """Max of `t` over the ranks along `axes`, IN PLACE (returned)."""
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def reset_counts(self) -> None:
        self.counts = {"asked": 0, "issued": 0}


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    return Mesh(shape, axis_names, device=device)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ("data", "model") mesh over the running ranks. Unlike the
    reference's, which shrinks the mesh to the devices it finds, this
    raises when the world size is not data * model."""
    return Mesh((data, model), ("data", "model"), device=device)
