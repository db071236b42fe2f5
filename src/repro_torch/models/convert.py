"""Carry parameters and training state between the JAX package and the
port.

`repro.models.transformer.Model.init_params` returns a nested dict whose
per-layer leaves are stacked along a leading axis (the reference scans
over layers): `layers` (L, ...), or (L - 1, ...) for moe with a dense
first layer, whose `layer0` is not stacked; hybrid's `triples` (L // 3,
...) beside its unstacked `tail_rec<j>`; encdec's `enc_layers` and
`dec_layers` (`transformer.stacked_layers`). Given that tree as numpy
arrays, `params_from_jax` returns the port's state dict:
`<stack>.<i>.<path>` for layer i of each stacked leaf, the other leaves
under their dotted path,
every tensor in its declared dtype (the config's, float32 for the MoE
router, the SSM's `A_log` and `D`, the RG-LRU's `b_a`, `b_i` and
`Lambda`). `params_to_jax` is its inverse:
the port's dict back to the nested, layer-stacked tree, as float32 numpy
arrays (exact for bfloat16, which numpy holds only as an extension type;
the reference casts a loaded leaf to its own dtype). With them both
packages compute from the same weights, and a checkpoint of either
restores in the other.

The AdamW state crosses the same way: `opt_state_from_jax` takes the
reference's `AdamWState(step, mu, nu, master)` (or a tuple in that field
order) to the port's, float32 moments and master copy; `opt_state_to_jax`
returns the four fields for the reference's `AdamWState(*fields)`.

Over a mesh (`launch.mesh.Mesh`) each rank holds its blocks
(`models.sharding`): `local_state` cuts a full flat dict (such as
`params_from_jax`'s) to this rank's blocks and `full_state` gathers the
blocks back (for `stack_layers` and the checkpoints).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model, stacked_layers
from repro_torch.optim.adamw import AdamWState


def state_specs(cfg: ModelConfig, mesh) -> dict:
    """{parameter name: spec} of `cfg`'s model on `mesh` (a model on the
    meta device: nothing allocated)."""
    return sh.spec_tree(Model(cfg, "meta"), None, mesh)


def local_state(cfg: ModelConfig, state: dict, mesh) -> dict:
    """A full flat dict under the port's names (params, or AdamW's
    moments) -> this rank's blocks (`sharding.local_slice`)."""
    specs = state_specs(cfg, mesh)
    return {k: sh.local_slice(t, specs[k], mesh) for k, t in state.items()}


def full_state(cfg: ModelConfig, state: dict, mesh) -> dict:
    """This rank's blocks -> the full flat dict (`sharding.gather_tree`:
    a collective, every rank of the mesh calls it)."""
    return sh.gather_tree(state, state_specs(cfg, mesh), mesh)


def params_from_jax(cfg: ModelConfig, tree: dict, dtype=None) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's state dict,
    every tensor in `dtype`, or by default in its declared dtype."""
    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(c) for k, c in node.items()}
        # a float32 copy: exact for bfloat16 leaves, which numpy holds
        # only as an extension type, and writable as torch wants it
        return torch.from_numpy(np.array(node, np.float32))

    flat = unstack_layers(cfg, tensors(tree))
    if dtype is not None:
        return {k: t.to(dtype) for k, t in flat.items()}
    # the declared dtypes, from a model on the meta device (nothing
    # allocated)
    declared = {k: p.dtype for k, p in
                Model(cfg, "meta").named_parameters()}
    return {k: t.to(declared.get(k, cfg.torch_dtype))
            for k, t in flat.items()}


def params_to_jax(cfg: ModelConfig, state: dict) -> dict:
    """The port's state dict (or any dict under its names, such as AdamW's
    moments) -> the reference's nested tree, the layers stacked on a
    leading axis, leaves float32 numpy arrays."""
    def arrays(node):
        if isinstance(node, dict):
            return {k: arrays(c) for k, c in node.items()}
        return node.detach().to(device="cpu", dtype=torch.float32).numpy()

    return arrays(stack_layers(cfg, state))


def stack_layers(cfg: ModelConfig, state: dict) -> dict:
    """The port's flat dict of tensors -> the reference's nested layout
    (`<stack>.<i>.<path>` stacked into one (n, ...) tensor at
    <stack>/<path> for each of `stacked_layers(cfg)`), tensors kept in
    their dtype and on their device."""
    tree: dict = {}
    stacks = stacked_layers(cfg)
    stacked: dict = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] in stacks:
            stacked.setdefault((parts[0],) + tuple(parts[2:]),
                               {})[int(parts[1])] = t
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    for path, by_layer in stacked.items():
        n = stacks[path[0]]
        if sorted(by_layer) != list(range(n)):
            raise ValueError(f"{path[0]}.*.{'.'.join(path[1:])}: layers "
                             f"{sorted(by_layer)}, config stacks {n}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.stack([by_layer[i].detach()
                                      for i in range(n)])
    return tree


def unstack_layers(cfg: ModelConfig, tree: dict) -> dict:
    """`stack_layers`'s inverse: a nested tree of tensors -> the port's
    flat dict (layer i of a stacked leaf is a view of it)."""
    out = {}
    _unstack((), tree, stacked_layers(cfg), out)
    return out


def _unstack(path, node, stacks: dict, out: dict) -> None:
    # a module function: a nested one calling itself would hold `out` in
    # a reference cycle, its tensors alive until a garbage collection
    if isinstance(node, dict):
        for key, child in node.items():
            _unstack(path + (key,), child, stacks, out)
        return
    if path[0] in stacks:
        n = stacks[path[0]]
        if node.shape[0] != n:
            raise ValueError(f"{'.'.join(path)}: {node.shape[0]} "
                             f"stacked layers, config stacks {n}")
        for i in range(n):
            out[".".join((path[0], str(i)) + path[1:])] = node[i]
    else:
        out[".".join(path)] = node


def load_jax_params(model, tree: dict) -> None:
    """Load a reference parameter tree into `model` (every parameter,
    strictly: a missing or extra name raises)."""
    model.load_state_dict(params_from_jax(model.cfg, tree), strict=True)


def opt_state_from_jax(cfg: ModelConfig, state, device="cpu") -> AdamWState:
    """The reference's AdamWState (numpy leaves, or a tuple (step, mu, nu,
    master)) -> the port's, on `device`."""
    step, mu, nu, master = tuple(state)

    def moments(tree):
        if tree is None:
            return None
        return {k: t.to(device) for k, t in
                params_from_jax(cfg, tree, torch.float32).items()}

    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        moments(mu), moments(nu), moments(master))


def opt_state_to_jax(cfg: ModelConfig, state: AdamWState) -> tuple:
    """The port's AdamWState -> (step int32 array, mu, nu, master or None)
    as the reference's trees: `repro.optim.adamw.AdamWState(*fields)`."""
    return (np.asarray(int(state.step), np.int32),
            params_to_jax(cfg, state.mu), params_to_jax(cfg, state.nu),
            None if state.master is None
            else params_to_jax(cfg, state.master))
