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

Not ported, because one card holds every parameter whole: the
logical-axis rules (`DEFAULT_RULES`, `ShardingRules`), `resolve_spec`,
`spec_tree`, `shard_params` and `constrain`. They map logical axes onto a
device mesh for pjit; a multi-card slice would map them onto
`torch.distributed` instead (ROADMAP).
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

    def __init__(self, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.device = torch.device(device)
        self.inits: dict[str, Init] = {}

    def declare(self, name: str, shape, init: Init,
                dtype: Optional[torch.dtype] = None) -> None:
        """Declare parameter `name`, in `dtype` (the module's by
        default)."""
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), dtype=dtype or self.dtype,
                        device=self.device),
            requires_grad=False))
        self.inits[name] = init


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
