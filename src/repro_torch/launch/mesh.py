"""Device meshes of the port over `torch.distributed`.

Counterpart of `repro.launch.mesh`: a `Mesh` names its axes, ("data",
"model") or ("pod", "data", "model") for the reference's multi-pod case,
and lays the ranks out row-major over them, so rank = (pod * D + data) * M
+ model. One process runs each rank (started by `torchrun` or
`torch.multiprocessing`); a world of 1 starts itself.

The sharded backend reduces over three kinds of groups: the data-like
axes (the ranks that share a model column), the model axis (the ranks that
share a data row), and all ranks. `Mesh.psum` / `Mesh.pmax` take the axes
by name. LM training (`train.steps`) adds `Mesh.all_gather`, the ranks'
tensors along the axes concatenated in rank order, and
`Mesh.psum_ordered`, a sum over the axes added in rank order from an
all-gather: gloo with CUDA tensors (two ranks on one card) has no
reduce-scatter, and a ring all-reduce adds in an order that depends on
the chunk, so this sum is the one whose bits do not depend on the
group's algorithm. `Mesh.psum_scatter_ordered` is the same sum of which
each rank receives only its own piece: an all-to-all, then the ranks'
pieces added in rank order (`dist.reduce_scatter` promises no order). A
collective over axes of total size 1 is the identity and issues nothing,
as XLA compiles a psum over a size-1 axis to nothing; `Mesh.counts`
tells the collectives asked for from those issued, and counts the bytes
the issued ones bring the rank from the others (an all-gather's or an
ordered sum's n - 1 tensors, an all-to-all's n - 1 pieces, an
all-reduce's 2 (n - 1) / n of the tensor, as a ring moves it).

The compute split along "model" (`models.sharding.Split`) needs
collectives that autograd sees, all on `psum_ordered` and the ranks'
all-gather, so their bits are equal on every rank and from run to run
(`Split.enter`, `leave` and `gather` apply them):

    Enter(x, mesh, axes)    -- into a split region: x forward, its
        gradient summed over the axes in rank order backward
    Leave(x, mesh, axes)    -- out of one: the ranks' partials summed in
        rank order (float32 accumulators, cast back) forward, the
        gradient as it is backward
    GatherBlock(t, mesh, axes, dim, partial)  -- the ranks' blocks
        concatenated along dim forward; backward the rank's block of the
        gradient, summed over the axes first where each rank's use gave
        only a part of it (`partial`)

and `Mesh.pmax_ordered(x, axes)`, the elementwise max over the axes (no
gradient). FSDP over the data axes (`models.sharding.DataGather`) has
one more:

    GatherScatter(handle, gather, scatter, *blocks)  -- `gather(blocks)`
        forward (a layer's blocks gathered); backward `scatter(grads)`,
        which keeps what it makes (the rank's float32 blocks of the
        gradients summed over the data axes) rather than returning it to
        autograd, which would cast it to the blocks' dtype

Under `torch.utils.checkpoint` (non-reentrant) a layer's forward
collectives run again in its recompute; the ranks run one graph, so they
issue them in one order.

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


def check_world(shape: Sequence[int], axis_names: Sequence[str],
                world: int) -> None:
    """Raise unless a mesh of `shape` over `axis_names` takes `world`
    ranks."""
    need = 1
    for a in shape:
        need *= int(a)
    if world != need:
        raise ValueError(
            f"mesh {dict(zip(axis_names, shape))} needs {need} ranks, the "
            f"process group has {world}; start {need} ranks (torchrun "
            f"--nproc-per-node {need}) or change the mesh")


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
        backend = init_distributed(device)
        world = dist.get_world_size()
        check_world(shape, names, world)
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
        self.reset_counts()

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
        self._issued(2 * (self.size(axes) - 1) * t.nbytes
                     // self.size(axes))
        dist.all_reduce(t, op=op, group=self._group(axes))
        return t

    def _issued(self, nbytes: int) -> None:
        """Count one collective issued that brings the rank `nbytes`."""
        self.counts["issued"] += 1
        self.counts["bytes"] += int(nbytes)

    def _gathered(self, t: Tensor, axes: Tuple[str, ...]) -> list:
        """The tensors of the ranks along `axes` (of size > 1), in rank
        order (row-major over the axes: a group's ranks ascend)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size(axes))]
        self._issued((len(parts) - 1) * t.nbytes)
        dist.all_gather(parts, t, group=self._group(axes))
        return parts

    def all_gather(self, t: Tensor, axes, dim: int = 0) -> Tensor:
        """The tensors of the ranks along `axes` concatenated along `dim`
        in rank order (`t` itself over axes of size 1)."""
        axes = self._axes(axes)
        self.counts["asked"] += 1
        if self.size(axes) == 1:
            return t
        return torch.cat(self._gathered(t, axes), dim=dim)

    def psum_ordered(self, t: Tensor, axes, dtype=None) -> Tensor:
        """Sum of `t` over the ranks along `axes`, in `dtype` (t's by
        default), added in rank order: bit-equal on every rank and from
        run to run, whatever the group's algorithm. A new tensor; `t`
        itself (cast to `dtype`) over axes of size 1."""
        axes = self._axes(axes)
        dtype = dtype or t.dtype
        self.counts["asked"] += 1
        if self.size(axes) == 1:
            return t.to(dtype)
        parts = self._gathered(t.reshape(-1), axes)
        out = parts[0].to(dtype, copy=True)
        for part in parts[1:]:
            out += part.to(dtype)
        return out.view(t.shape)

    def psum_scatter_ordered(self, t: Tensor, axes, dtype=None) -> Tensor:
        """The sum over the ranks along `axes` of their `t[i]`, for this
        rank's index i over the axes (`t` of shape (n, ...), n the axes'
        size; row j is rank j's piece), in `dtype` (t's by default),
        added in rank order: the rank's piece of `psum_ordered(t)`, bit
        for bit, from one all-to-all that brings it n - 1 pieces rather
        than n - 1 whole tensors. `t[0]` (cast to `dtype`) over axes of
        size 1."""
        axes = self._axes(axes)
        dtype = dtype or t.dtype
        n = self.size(axes)
        if t.shape[0] != n:
            raise ValueError(f"psum_scatter_ordered over {axes} takes {n} "
                             f"pieces, got a leading dim of {t.shape[0]}")
        self.counts["asked"] += 1
        if n == 1:
            return t[0].to(dtype)
        t = t.contiguous()
        parts = torch.empty_like(t)
        self._issued((n - 1) * t[0].nbytes)
        dist.all_to_all_single(parts, t, group=self._group(axes))
        out = parts[0].to(dtype, copy=True)
        for part in parts[1:]:
            out += part.to(dtype)
        return out

    def pmax_ordered(self, t: Tensor, axes) -> Tensor:
        """Elementwise max of `t` over the ranks along `axes`, from the
        ranks' all-gather (exact in any order); a new tensor, `t` itself
        over axes of size 1. No gradient."""
        axes = self._axes(axes)
        self.counts["asked"] += 1
        if self.size(axes) == 1:
            return t
        return torch.stack(self._gathered(t, axes)).amax(0)

    def barrier(self) -> None:
        """Wait for every rank (nothing in a world of 1)."""
        if self.world > 1:
            dist.barrier()

    def psum(self, t: Tensor, axes) -> Tensor:
        """Sum of `t` over the ranks along `axes`, IN PLACE (returned)."""
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmax(self, t: Tensor, axes) -> Tensor:
        """Max of `t` over the ranks along `axes`, IN PLACE (returned)."""
        return self._reduce(t, axes, dist.ReduceOp.MAX)

    def reset_counts(self) -> None:
        self.counts = {"asked": 0, "issued": 0, "bytes": 0}


class Enter(torch.autograd.Function):
    """`x`, replicated over `axes`, into a region where each rank
    computes its part: the identity forward; backward the ranks'
    gradients summed in rank order (float32, cast back)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.psum_ordered(g, ctx.axes, torch.float32).to(g.dtype),
                None, None)


class Leave(torch.autograd.Function):
    """The ranks' partials `x` summed over `axes` in rank order
    (float32 accumulators, cast back to x's dtype): replicated again.
    Backward the gradient as it is (equal on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum_ordered(x, axes, torch.float32).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class GatherBlock(torch.autograd.Function):
    """The ranks' blocks `t` along `axes` concatenated along `dim` in
    rank order. Backward this rank's block of the gradient: summed over
    the axes first when `partial` (each rank used only a part of the
    whole: inside a split region), taken as it is otherwise (every rank
    used all of it alike)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, partial):
        ctx.mesh, ctx.axes, ctx.dim, ctx.partial = mesh, axes, dim, partial
        return mesh.all_gather(t, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.partial:
            g = mesh.psum_ordered(g, axes, torch.float32).to(g.dtype)
        n = g.shape[dim] // mesh.size(axes)
        return (g.narrow(dim, mesh.index(axes) * n, n).contiguous(), None,
                None, None, None)


class GatherScatter(torch.autograd.Function):
    """`gather(blocks)` forward: the tensors computed with (a layer's
    blocks gathered over the data axes). Backward `scatter(grads)` with
    their gradients, which keeps what it makes (the rank's blocks, summed
    over the data axes in float32) instead of handing it to autograd:
    autograd casts the gradient of an input to the input's dtype, and
    the sum must reach the optimizer as float32. `handle`, a scalar that
    requires grad, is the input for which autograd runs this backward
    (`torch.autograd.grad` reaches only nodes on the way to the inputs it
    is asked for); its gradient is 0."""

    @staticmethod
    def forward(ctx, handle, gather, scatter, *blocks):
        ctx.scatter = scatter
        return tuple(gather(blocks))

    @staticmethod
    def backward(ctx, *grads):
        ctx.scatter(grads)
        return (torch.zeros((), device=grads[0].device), None, None,
                *(None,) * len(grads))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    return Mesh(shape, axis_names, device=device)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda") -> Mesh:
    """A ("data", "model") mesh over the running ranks. Unlike the
    reference's, which shrinks the mesh to the devices it finds, this
    raises when the world size is not data * model."""
    return Mesh((data, model), ("data", "model"), device=device)
