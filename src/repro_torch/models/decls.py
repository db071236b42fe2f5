"""Parameter declaration and initialisation: the declaration/init part of
`repro.models.sharding`.

Every parameter is declared once, by the module that owns it, with a shape,
the module's dtype (or its own: the reference declares the MoE router and
the SSM's `A_log` and `D` in float32 inside a bf16 model) and an init rule:
normal with stddev 1/sqrt(fan_in) (`dense`), normal with stddev 0.02
(`embedding`), zeros, ones or a constant (`const`), optionally with the
slices of padded heads zeroed (`padded`). `init_params` draws
every declared parameter of a model, in declaration order, from one
explicit `torch.Generator`; normals are drawn in float32 and cast, as the
reference's `_normal_init` does. The two packages draw different numbers
from the same seed: tests carry the reference's weights over with
`models.convert.params_from_jax`.

Each parameter also carries the reference's logical axes (`axes=`, one
name or None a dim: "embed", "heads", "ff", ...; `logical_axes(model)`).
`models.sharding` maps them onto a port mesh (`resolve_spec`,
`spec_tree`) for the sharded train step. The reference's `shard_params`
and `constrain` place arrays for pjit and have no counterpart.

A module keeps each parameter's declared (whole) shape, and `split`, the
rank's `sharding.Split` while the train step computes split along
"model" (None otherwise, `Model.split_compute`): `split_on(name, dim)`
is that split where the tensor bound to `name` (under
`torch.func.functional_call`, the rank's block) is a block of the
declared dim, else None.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Init:
    kind: str                     # normal | zeros | ones | const
    stddev: float = 0.0
    value: float = 0.0            # const
    # (dim, real): zero the slices >= real along dim (padded heads), so
    # head padding is output-exact at init
    pad: Optional[Tuple[int, int]] = None


ZEROS = Init("zeros")
ONES = Init("ones")
EMBEDDING = Init("normal", 0.02)


def const(value: float) -> Init:
    return Init("const", value=value)


def dense(fan_in: int) -> Init:
    return Init("normal", 1.0 / math.sqrt(fan_in))


def padded(init: Init, dim: int, real: int) -> Init:
    return dataclasses.replace(init, pad=(dim, real))


class Declared(nn.Module):
    """A module whose parameters carry their init rule. Parameters are
    allocated uninitialised (`torch.empty`, also on the meta device) and
    take no gradients themselves: the train step (`train.steps`) passes
    its own tensors through `torch.func.functional_call` and
    differentiates those."""

    split = None

    def __init__(self, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.device = torch.device(device)
        self.inits: dict[str, Init] = {}
        self.axes: dict[str, Tuple[Optional[str], ...]] = {}
        self.shapes: dict[str, Tuple[int, ...]] = {}

    def split_on(self, name: str, dim: int):
        """`self.split` where the tensor bound to `name` is a block of its
        declared dim `dim`, else None."""
        if self.split is None:
            return None
        bound = getattr(self, name).shape[dim]
        return self.split if bound < self.shapes[name][dim] else None

    def declare(self, name: str, shape, init: Init, *, axes,
                dtype: Optional[torch.dtype] = None) -> None:
        """Declare parameter `name` with its logical axes (a name or None
        a dim), in `dtype` (the module's by default)."""
        shape, axes = tuple(shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape}, logical axes {axes}")
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype or self.dtype,
                        device=self.device),
            requires_grad=False))
        self.inits[name] = init
        self.axes[name] = axes
        self.shapes[name] = shape


def logical_axes(model: nn.Module) -> dict:
    """{parameter name: its declared logical axes} over
    `model.named_parameters()`."""
    out = {}
    for prefix, module in model.named_modules():
        if isinstance(module, Declared):
            for name, axes in module.axes.items():
                out[f"{prefix}.{name}" if prefix else name] = axes
    return {name: out[name] for name, _ in model.named_parameters()}


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every declared parameter of `model` from `generator` (on the
    parameters' device), in declaration order."""
    for module in model.modules():
        if not isinstance(module, Declared):
            continue
        for name, init in module.inits.items():
            p = getattr(module, name)
            if init.kind == "normal":
                w = torch.randn(p.shape, generator=generator,
                                dtype=torch.float32, device=p.device)
                p.copy_(w.mul_(init.stddev))
            elif init.kind == "zeros":
                p.zero_()
            elif init.kind == "ones":
                p.fill_(1.0)
            elif init.kind == "const":
                p.fill_(init.value)
            else:
                raise ValueError(f"unknown init {init.kind!r}")
            if init.pad is not None:
                dim, real = init.pad
                p.narrow(dim, real, p.shape[dim] - real).zero_()
