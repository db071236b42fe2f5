"""Logical-axis placement of the LM's parameters over a port `Mesh`: the
placement half of `repro.models.sharding` (the declaration half is
`models.decls`).

Every parameter is declared with a tuple of logical axis names
(`Declared.declare(..., axes=)`, the reference's `ParamDecl.logical_axes`).
`ShardingRules` maps a logical name to mesh axes; `resolve_spec` turns a
shape and its logical axes into a spec, a tuple with one entry a dim
(None, a mesh axis, or a tuple of them), trailing Nones dropped, as the
reference's `PartitionSpec` is: it never uses a mesh axis twice, and
drops a rule that does not divide the dim (that dim is replicated). So
one rule set serves every architecture and mesh. Under `DEFAULT_RULES`
"embed" splits over "data" (FSDP) and heads, ff, vocab, experts and the
lru / ssm channels over "model".

The reference stacks a leading "layers" axis on each layer's leaves and
maps it to no mesh axis; the port holds one module a layer, so its spec
of a layer's parameter is the reference's with that leading None
dropped.

    spec_tree(model, rules, mesh)   -- {name: spec} over the model's
        parameters
    local_slice(t, spec, mesh)      -- this rank's block of a full tensor
    gather(t, spec, mesh)           -- a block back to the full tensor
    gather_tree(tree, specs, mesh)  -- every block of a {name: tensor}
        dict, in one all-gather a set of mesh axes and dtype
    psum_scatter_tree(tree, specs, mesh, axes)  -- each whole tensor of a
        dict summed over the axes into the rank's block alone (rank
        order, float32), one all-to-all a dtype up to
        EXCHANGE_ROW_BYTES a row
    packed(tree, names, fn)         -- one collective a dtype over leaves
        packed flat, each leaf's piece of the result back
    counted_once(spec, mesh)        -- whether this rank's block counts in
        a sum over the whole tree (`optim.adamw.global_norm`)

A rank's block along a dim split over axes A is the `mesh.index(A)`-th
of `mesh.size(A)` equal pieces, the order `Mesh.all_gather` concatenates
in, so `gather(local_slice(t))` is `t` bit for bit. A spec whose axes
all have size 1 (every spec on a mesh of one) slices nothing:
`local_slice` and `gather` return the tensor itself.

    restrict(spec, axes)            -- the spec's entries over `axes`
        only (the train step gathers over the data axes alone)

FSDP over the data axes (`DataGather`, the train step's): the leaves
outside the layers are gathered once at the step's start; each layer's
body gathers the layer's blocks (one packed all-gather a dtype) inside
its forward and again inside its remat recompute, as the reference's
pjit gathers its scanned layer body's slice of each weight under the
"embed" -> "data" rule; and each gradient is summed over the data axes
only into the block the rank keeps (`psum_scatter_tree`, in the layer's
backward for its leaves): a rank holds one layer's whole weights at a
time, and the exchange brings it D - 1 pieces the size of its blocks
((D - 1) / D of the gradients whole over "data"), not D - 1 whole
gradients.

The compute half. Over a mesh whose "model" axis has more than one rank,
the train step binds each rank's "model" blocks (whole over "data" once
gathered) into the model (`torch.func.functional_call`) and
`Model.split_compute(Split(mesh))` tells every module which rank it runs
on; a module reads what it computes with from the blocks it is given,
the reference's GSPMD layout under `DEFAULT_RULES`:

- column splits (attention's heads and kv heads, the MLP's ff columns,
  the experts or the expert_ff columns, the lru / ssm_inner channels,
  the vocabulary's rows of the logits) run on `Split.enter(x)`: x as it
  is forward, its gradient summed over "model" backward;
- row splits (wo, w_down, the moe combine, out_proj, the RG-LRU's out,
  x_proj, the embedding lookup) give each rank a partial sum, which
  `Split.leave` adds over "model" in rank order;
- a weight replicated over "model" whose output only some of the rank's
  work uses (kv projections that "model" does not divide, the moe
  router) runs on the replicated input outside the split region, and
  its output enters it: the weight's gradient is then whole and equal on
  every rank, the sum over "model" having been taken on the output's
  gradient;
- the rest (norms, biases added after an exit sum) runs replicated.

Three storage blocks are not the blocks a rank computes with; the step
moves what it needs, the cheaper way at full width (bytes a rank
receives over "model" = 2 a layer a step, forward, recompute and
backward):

- the fused `wqkv` (d, H + 2 Kv, Dh), split on its fused dim: a
  contiguous slice of it is not "the rank's q heads and their kv
  heads". The weight is gathered (`Split.gather`) and the rank's rows
  taken (`qkv_rows`): at qwen2-0.5b's width 2.1 MB bf16 against a (2,
  4096, 18 x 64) activation's 18.9 MB. No config fuses it.
- mamba's `in_proj` (d, 2 Di) over ssm_inner: at M = 2 rank 0 stores
  all of x and rank 1 all of z. The rank's product with its stored
  columns is gathered and its x and z channels taken (`in_proj_columns`):
  at falcon-mamba-7b's width and its train shape (1 x 2048) a (2048,
  16384) bf16 activation, 67 MB, against the weight's 134 MB; the
  weight is the cheaper one from d tokens on (4096).
- the RG-LRU's `w_a` / `w_i` (W, W) over ("lru", "lru"), whose columns
  `resolve_spec` leaves whole: the weights (13.1 MB bf16 each at
  recurrentgemma-2b's W 2560) and the post-conv activation (1 x 4096 x
  2560 bf16, 21 MB) are gathered and the rank's columns taken, ~94 MB
  a layer a step, against ~252 MB to sum the float32 row-split products
  (42 MB each) over "model".

Each gradient comes back as the stored block.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import (Enter, GatherBlock, GatherScatter,
                                     Leave)
from repro_torch.models import decls

Tensor = torch.Tensor

# The most bytes a row of one gradient exchange over the data axes holds
# (`psum_scatter_tree`): a layer's leaves, and qwen2-0.5b's bf16
# embedding block at (2, 1), go in one exchange.
EXCHANGE_ROW_BYTES = 256 * 2 ** 20

# Default logical-axis -> mesh-axis rules: the reference's DEFAULT_RULES.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "embed": ("data",),        # FSDP dim for 2-D weight sharding
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "experts": ("model",),
    # expert_ff engages only when "experts" could not take the model axis
    # (E < mesh model size): the per-expert FFN then splits along d_ff
    "expert_ff": ("model",),
    "lru": ("model",),         # RG-LRU / mamba inner channels
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "seq": (),
    "layers": (),              # the reference's scan dim, never sharded
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def mesh_axes_for(self, logical: str) -> Tuple[str, ...]:
        return tuple(self.rules.get(logical, ()))


def default_rules(**overrides) -> ShardingRules:
    r = dict(DEFAULT_RULES)
    r.update(overrides)
    return ShardingRules(r)


def _sizes(mesh) -> Mapping[str, int]:
    """A mesh's {axis: size}: a port `Mesh`'s `shape`, or the mapping
    itself."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def resolve_spec(shape: Sequence[int], logical_axes, rules: ShardingRules,
                 mesh) -> tuple:
    """Logical axes -> spec (see the module docstring) over `mesh`, a
    port `Mesh` or an {axis: size} mapping: the reference's function,
    entry for entry."""
    sizes = _sizes(mesh)
    used = set()
    parts = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            parts.append(None)
            continue
        chosen = []
        prod = 1
        for ax in rules.mesh_axes_for(name):
            if ax in used or ax not in sizes:
                continue
            sz = sizes[ax]
            if dim % (prod * sz) == 0:
                chosen.append(ax)
                used.add(ax)
                prod *= sz
        if not chosen:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(tuple(chosen))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_tree(model, rules: Optional[ShardingRules], mesh) -> dict:
    """{parameter name: spec} over `model.named_parameters()`, from each
    parameter's declared logical axes."""
    rules = rules or default_rules()
    axes = decls.logical_axes(model)
    return {name: resolve_spec(p.shape, axes[name], rules, mesh)
            for name, p in model.named_parameters()}


def _entry_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split_dims(spec: tuple, mesh) -> list:
    """[(dim, axes)] of the dims `spec` splits over axes of size > 1."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _entry_axes(entry)
        if mesh.size(axes) > 1:
            out.append((dim, axes))
    return out


def _block(t: Tensor, spec: tuple, mesh, coords: dict) -> Tensor:
    """The block of the full tensor `t` under `spec` of the rank at mesh
    coordinates `coords`, a view (`t` itself where nothing splits)."""
    for dim, axes in _split_dims(spec, mesh):
        index = 0
        for a in mesh._axes(axes):
            index = index * mesh.shape[a] + coords[a]
        n = t.shape[dim] // mesh.size(axes)
        t = t.narrow(dim, index * n, n)
    return t


def local_slice(t: Tensor, spec: tuple, mesh) -> Tensor:
    """This rank's block of the full tensor `t` under `spec`: a new
    contiguous tensor, so the full one can be freed; `t` itself when the
    spec splits nothing on this mesh."""
    if not _split_dims(spec, mesh):
        return t
    return _block(t, spec, mesh, mesh.coords).clone(
        memory_format=torch.contiguous_format)


def gather(t: Tensor, spec: tuple, mesh) -> Tensor:
    """The full tensor from this rank's block under `spec` (one
    all-gather a split dim); `t` itself when the spec splits nothing."""
    for dim, axes in _split_dims(spec, mesh):
        t = mesh.all_gather(t, axes, dim=dim)
    return t


def _by_dtype(tree: dict, names) -> list:
    """`names` grouped by their leaves' dtype, in order."""
    groups: dict = {}
    for name in names:
        groups.setdefault(tree[name].dtype, []).append(name)
    return list(groups.values())


def packed(tree: dict, names, fn) -> dict:
    """{name: its piece of `fn`'s result} for the leaves `names` of
    `tree`: the leaves go flat into one buffer a dtype (in `names`'
    order), `fn(buffer)` runs once a buffer (one collective a dtype) and
    returns a tensor whose last dim is the buffer's, and each leaf gets
    its slice of that last dim in the leaf's shape, the leading dims
    kept."""
    out = {}
    for group in _by_dtype(tree, names):
        res = fn(torch.cat([tree[name].reshape(-1) for name in group]))
        off = 0
        for name in group:
            k = tree[name].numel()
            out[name] = res[..., off:off + k].reshape(
                *res.shape[:-1], *tree[name].shape)
            off += k
    return out


def gather_tree(tree: dict, specs: dict, mesh) -> dict:
    """`gather` of every leaf of `tree` ({name: block}), in one
    all-gather a (mesh axes, dtype) pair (`packed`): each block comes
    back from the ranks' pieces concatenated along its dim. Leaves that
    split nothing are returned as they are; the dict keeps `tree`'s
    order."""
    out = dict(tree)
    jobs: dict = {}
    for name, t in tree.items():
        for dim, axes in _split_dims(specs[name], mesh):
            jobs.setdefault(mesh._axes(axes), {})[name] = dim
    for axes, dims in jobs.items():
        n = mesh.size(axes)
        got = packed(out, list(dims), lambda flat: mesh.all_gather(
            flat, axes).view(n, -1))
        for name, ranks in got.items():
            out[name] = torch.cat(list(ranks.unbind(0)), dim=dims[name])
    return out


def _lead(shape) -> int:
    """The rows of a tensor of `shape` along its leading dim (1 for a
    0-d one)."""
    return shape[0] if len(shape) else 1


def _rows(t: Tensor, lo: int, hi: int) -> Tensor:
    """Rows lo:hi of `t`'s leading dim, a view (`t` if 0-d)."""
    return t.narrow(0, lo, hi - lo) if t.dim() else t


def _exchanges(shapes: dict, cap: int) -> list:
    """The pieces ({name: block shape}, in order) that go into one
    exchange each, up to `cap` elements a row: [[(name, lo, hi, elements)
    of rows lo:hi of its block, ...], ...]. A block above `cap` goes in
    pieces of its leading dim (a row above it whole)."""
    pieces = []
    for k, shape in shapes.items():
        row = math.prod(shape[1:])
        rows = max(1, cap // max(1, row))
        pieces += [(k, lo, min(lo + rows, _lead(shape)),
                    (min(lo + rows, _lead(shape)) - lo) * row)
                   for lo in range(0, _lead(shape), rows)]
    out, size = [[]], 0
    for piece in pieces:
        if out[-1] and size + piece[3] > cap:
            out.append([])
            size = 0
        out[-1].append(piece)
        size += piece[3]
    return out


def psum_scatter_tree(tree: dict, specs: dict, mesh, axes) -> dict:
    """Each leaf of `tree` ({name: this rank's full tensor}, the same
    shape on every rank) summed over the ranks along `axes`, of which the
    rank gets only its block under `specs[name]` (splits over `axes`
    alone: `restrict`), float32, added in rank order: bit for bit the
    rank's block of `Mesh.psum_ordered(leaf, axes, float32)`.

    The leaves of a dtype go through `Mesh.psum_scatter_ordered` packed
    into one buffer whose row j holds the blocks of rank j along the
    axes, which brings the rank its block from each other rank: one
    all-to-all a dtype while they fit in EXCHANGE_ROW_BYTES a row. Past
    that they go in several exchanges, a block larger than it in pieces
    of its leading dim, so what one exchange holds at once (the buffer,
    what it receives, their float32 sum) stays within about 3 x the
    axes' size x EXCHANGE_ROW_BYTES whatever the leaf (an untied
    256,000-token embedding's float32 gradient is 2.4 GiB whole).
    Consumes `tree`: a leaf leaves it once its last piece is copied into
    a buffer, so a caller that holds no other reference frees the whole
    tensors as they go. -> {name: block} in `tree`'s order."""
    axes = mesh._axes(axes)
    members = [{**mesh.coords, **dict(zip(axes, c))} for c in
               itertools.product(*(range(mesh.shape[a]) for a in axes))]
    order = list(tree)
    out = {}
    for names in _by_dtype(tree, order):
        first = tree[names[0]]
        dtype, device = first.dtype, first.device
        cap = max(1, EXCHANGE_ROW_BYTES // first.element_size())
        del first
        shapes = {k: _block(tree[k], specs[k], mesh, mesh.coords).shape
                  for k in names}
        for exchange in _exchanges(shapes, cap):
            buf = torch.empty((len(members), sum(p[3] for p in exchange)),
                              dtype=dtype, device=device)
            off = 0
            for k, lo, hi, n in exchange:
                for j, c in enumerate(members):
                    src = _rows(_block(tree[k], specs[k], mesh, c), lo, hi)
                    buf[j, off:off + n].view(src.shape).copy_(src)
                if hi == _lead(shapes[k]):
                    del tree[k]
                off += n
            flat = mesh.psum_scatter_ordered(buf, axes, torch.float32)
            del buf
            off = 0
            for k, lo, hi, n in exchange:
                if k not in out:
                    out[k] = flat.new_empty(shapes[k])
                dst = _rows(out[k], lo, hi)
                dst.copy_(flat[off:off + n].view(dst.shape))
                off += n
            del flat
    return {k: out[k] for k in order}


def restrict(spec: tuple, axes) -> tuple:
    """`spec` with only the mesh axes in `axes` kept (entries left with
    none are None, trailing Nones dropped)."""
    axes = set(axes)
    parts = []
    for entry in spec:
        kept = () if entry is None else tuple(
            a for a in _entry_axes(entry) if a in axes)
        parts.append(None if not kept else kept[0] if len(kept) == 1
                     else kept)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def counted_once(spec: tuple, mesh) -> bool:
    """Whether this rank's block of a leaf counts in a sum over the whole
    tree: the mesh axes the spec does not split along are copies, and
    only coordinate 0 on each of them counts, so each element counts
    once over the mesh."""
    split = {a for entry in spec if entry is not None
             for a in _entry_axes(entry)}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in split)


def describe(specs: dict, mesh) -> str:
    """One line on how `specs` place a model's leaves on `mesh`: the
    leaves split over each axis of size > 1, and those replicated."""
    parts = []
    split_any = set()
    for a in mesh.axis_names:
        if mesh.shape[a] == 1:
            continue
        names = [k for k, s in specs.items()
                 if any(a in _entry_axes(e) for e in s if e is not None)]
        split_any.update(names)
        parts.append(f"{len(names)} split over {a!r}")
    parts.append(f"{len(specs) - len(split_any)} replicated")
    return f"{len(specs)} leaves: " + ", ".join(parts)


# --- FSDP over the data axes -------------------------------------------------

class DataGather:
    """FSDP over the data axes of `mesh` for `model`'s train step, as
    the reference's pjit runs its scanned layer body under "embed" ->
    "data": each layer's leaves stay the rank's blocks until the layer
    runs.

    - `bind(layer, blocks)` (the layer's body, `Model.gathering`) gathers
      all of a layer's blocks over `axes` at its start, in one packed
      all-gather a dtype (`gather_tree`), in its forward and again in
      its remat recompute; its backward exchanges the layer's gradients
      (`reduce`) into `grads`, the rank's blocks.
    - The leaves outside the layers (`Model.layers_run()`), `top`: the
      embedding, the final norms, are gathered once by the step, and
      `finish` sends their gradients through `reduce` after the backward.
    - `reduce`: with `summed` (the rows split over the data axes) each
      gradient is summed over `axes` into the rank's block alone, in
      rank order, float32 (`psum_scatter_tree`); else every rank has the
      whole gradient already and keeps its block.

    A leaf with no dim over `axes` is the same on every rank and is
    bound as it is; its gradient is summed all the same."""

    def __init__(self, model, mesh, axes, summed: bool):
        self.mesh, self.axes, self.summed = mesh, tuple(axes), summed
        self.specs = {k: restrict(spec, self.axes)
                      for k, spec in spec_tree(model, None, mesh).items()}
        layers = {id(m) for m in model.layers_run()}
        self.prefix = {id(m): name + "." for name, m in model.named_modules()
                       if id(m) in layers}
        inside = tuple(self.prefix.values())
        self.top = [k for k in self.specs if not k.startswith(inside)]
        self.handle, self.grads = None, {}

    def begin(self, device) -> Tensor:
        """A new step: `grads` emptied, and the handle whose gradient
        makes autograd run every layer's exchange (`GatherScatter`)."""
        self.grads = {}
        self.handle = torch.zeros((), device=device, requires_grad=True)
        return self.handle

    def bind(self, layer, blocks: dict) -> dict:
        """{name: whole over the data axes} for `layer`'s blocks
        ({name under the layer: block})."""
        names = [self.prefix[id(layer)] + k for k in blocks]
        full = GatherScatter.apply(
            self.handle, functools.partial(self._gather, names),
            functools.partial(self._scatter, names), *blocks.values())
        return dict(zip(blocks, full))

    def _gather(self, names, blocks):
        out = gather_tree(dict(zip(names, blocks)), self.specs, self.mesh)
        return [out[k] for k in names]

    def _scatter(self, names, grads):
        self.grads.update(self.reduce(dict(zip(names, grads))))

    def finish(self, top: dict, order) -> dict:
        """-> {name: the rank's block of its gradient} in `order`: the
        layers' (exchanged in the backward) and those of `top` ({name:
        whole gradient} of the leaves outside the layers, through
        `reduce` here, which consumes `top`). The step's blocks are let
        go."""
        blocks = {**self.grads, **self.reduce(top)}
        self.grads, self.handle = {}, None
        return {k: blocks[k] for k in order}

    def reduce(self, grads: dict) -> dict:
        """{name: the rank's block} of whole gradients (see the class
        docstring); consumes `grads` (`psum_scatter_tree`)."""
        if self.summed:
            return psum_scatter_tree(grads, self.specs, self.mesh, self.axes)
        return {k: local_slice(grads.pop(k), self.specs[k], self.mesh)
                for k in list(grads)}


# --- the compute layout along "model" ----------------------------------------

class Split:
    """One rank's place along "model" for the compute split (see the
    module docstring): its `index` of `size` ranks, and the collectives
    over that axis that autograd sees (`launch.mesh.Enter`, `Leave`,
    `GatherBlock`)."""

    def __init__(self, mesh, axis: str = "model"):
        self.mesh = mesh
        self.axes = (axis,)
        self.size = mesh.size(axis)
        self.index = mesh.index(axis)

    @classmethod
    def over(cls, mesh, axis: str = "model") -> Optional["Split"]:
        """The split of `mesh` along `axis`, or None where the mesh has no
        such axis or one of size 1 (nothing splits: the one-rank path)."""
        if mesh is None or axis not in mesh.shape or mesh.size(axis) == 1:
            return None
        return cls(mesh, axis)

    def block(self, n_local: int) -> int:
        """The first of this rank's `n_local` entries of a split dim."""
        return self.index * n_local

    def enter(self, x: Tensor) -> Tensor:
        """`x`, equal on every rank, into the split region."""
        return Enter.apply(x, self.mesh, self.axes)

    def leave(self, x: Tensor) -> Tensor:
        """The ranks' partials `x` summed: out of the split region."""
        return Leave.apply(x, self.mesh, self.axes)

    def gather(self, t: Tensor, dim: int, partial: bool = True) -> Tensor:
        """The ranks' blocks `t` concatenated along `dim`."""
        return GatherBlock.apply(t, self.mesh, self.axes, dim, partial)


def kv_heads_of(H: int, Kv: int, h_lo: int, n: int):
    """The kv heads that q heads h_lo .. h_lo + n - 1 of H over Kv read
    (q head h reads kv head h // (H // Kv)) -> (kv_lo, kv_n), a
    contiguous run that the n heads share in equal groups of n // kv_n,
    or a list of n kv heads, one a q head, where they do not."""
    G = H // Kv
    of = [h // G for h in range(h_lo, h_lo + n)]
    kv_lo, kv_n = of[0], of[-1] - of[0] + 1
    g = n // kv_n
    if n % kv_n == 0 and of == [kv_lo + i // g for i in range(n)]:
        return kv_lo, kv_n
    return of


def qkv_rows(H: int, Kv: int, h_lo: int, n: int) -> list:
    """The rows of a fused (d, H + 2 Kv, Dh) `wqkv` a rank computes with
    for q heads h_lo .. h_lo + n - 1: those q heads, then the kv heads
    they read (`kv_heads_of`) among k's rows and among v's."""
    kv = kv_heads_of(H, Kv, h_lo, n)
    kv = list(range(kv[0], kv[0] + kv[1])) if isinstance(kv, tuple) else kv
    return (list(range(h_lo, h_lo + n)) + [H + j for j in kv]
            + [H + Kv + j for j in kv])


def in_proj_columns(Di: int, lo: int, n: int) -> Tuple[slice, slice]:
    """The columns of mamba's (d, 2 Di) `in_proj` (x's, then z's) that
    carry ssm_inner channels lo .. lo + n - 1: (x's, z's)."""
    return slice(lo, lo + n), slice(Di + lo, Di + lo + n)
