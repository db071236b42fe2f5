"""Model assembly: port of `repro.models.transformer` for the dense
(yi, qwen, gemma), moe (deepseek, grok) and ssm (falcon-mamba) families.

    Model(cfg, device, use_kernels=True)   -- an nn.Module holding the
        parameters under the reference's names (`embed`, `layers.<i>.*`,
        moe's dense `layer0`, `final_norm`), one module per layer where
        the reference scans over layer-stacked parameters
    init_params(model, generator)          -- `models.decls`
    model.backbone(x, positions, train) / model.logits(tokens, train)
    model.loss_fn(batch) / model(batch)    -- the training loss; with
        `torch.func.functional_call(model, params, (batch,))` at `params`

A layer is a module whose forward(x, positions, use_kernels) returns the
new x first: a DenseLayer or MoELayer its rotated k and v after it (the
prefill's cache), an SSMLayer its recurrent state. Building a Model for
the hybrid, encdec or vlm family raises NotImplementedError. There is no
`_constrain`: it is a mesh-sharding hint, and the port runs on one card.
With `train=True` and `cfg.remat` each layer is recomputed in the
backward pass (`torch.utils.checkpoint`, non-reentrant), as the
reference wraps its scanned layer body in `jax.checkpoint`: a layer keeps
only its input, and K6 runs twice an attention layer a step.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

PORTED_FAMILIES = ("dense", "moe", "ssm")


class DenseLayer(nn.Module):
    """Attention then an MLP of `d_ff` (the config's by default): the
    dense family's layer, and deepseek's dense first layer."""

    def __init__(self, cfg: ModelConfig, device, d_ff: int = 0):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.make_norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.mlp = L.MLP(cfg, device, d_ff=d_ff)

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool):
        """-> (x after the layer, the layer's rotated k and its v)."""
        h, k, v = attn.attend_full(self.cfg, self.attn, self.norm1(x),
                                   positions, causal=True,
                                   window=self.cfg.attn_window,
                                   use_kernels=use_kernels)
        x = x + h
        return x + self.mlp(self.norm2(x)), k, v

    def decode(self, x: Tensor, cache: attn.KVCache):
        h, cache = attn.decode_step(self.cfg, self.attn, self.norm1(x), cache,
                                    window=self.cfg.attn_window)
        x = x + h
        return x + self.mlp(self.norm2(x)), cache


class MoELayer(nn.Module):
    """Causal attention, then the routed and shared experts: the capacity
    dispatch over a sequence, every expert on a decode step's tokens."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.make_norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.moe = moe_mod.MoE(cfg, device)

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool):
        """-> (x after the layer, the layer's rotated k and its v)."""
        h, k, v = attn.attend_full(self.cfg, self.attn, self.norm1(x),
                                   positions, causal=True,
                                   use_kernels=use_kernels)
        x = x + h
        return x + moe_mod.apply_moe(self.cfg, self.moe, self.norm2(x)), k, v

    def decode(self, x: Tensor, cache: attn.KVCache):
        h, cache = attn.decode_step(self.cfg, self.attn, self.norm1(x), cache)
        x = x + h
        return x + moe_mod.apply_moe_dense(self.cfg, self.moe,
                                           self.norm2(x)), cache


class SSMLayer(nn.Module):
    """A norm, then the Mamba block, with a residual."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.norm = L.make_norm(cfg, device)
        self.ssm = ssm_mod.SSM(cfg, device)

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool):
        """-> (x after the layer, the block's state after the sequence).
        positions and use_kernels are unused (no attention)."""
        h, state = ssm_mod.apply_ssm_block(self.cfg, self.ssm, self.norm(x))
        return x + h, state

    def decode(self, x: Tensor, state: ssm_mod.SSMState):
        h, state = ssm_mod.ssm_decode_step(self.cfg, self.ssm, self.norm(x),
                                           state)
        return x + h, state


class Model(nn.Module):
    """An LM of a ported family on `device` (cuda by default; "cpu" runs
    every kernel's plain version; "meta" allocates nothing, for counting).
    Parameters are uninitialised until `init_params` or a load.
    `use_kernels=False` sends the blockwise attention route to K6's plain
    version even on the card (the smoke run's agreement check)."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 use_kernels: bool = True):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"the port has {PORTED_FAMILIES} (ROADMAP Queue 1 item 6)")
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.use_kernels = use_kernels
        self.embed = L.Embed(cfg, device)
        if cfg.family == "moe" and cfg.moe.first_layer_dense:
            self.layer0 = DenseLayer(cfg, device, d_ff=cfg.moe.d_ff_dense)
        layer = {"dense": DenseLayer, "moe": MoELayer,
                 "ssm": SSMLayer}[cfg.family]
        self.layers = nn.ModuleList(layer(cfg, device)
                                    for _ in range(n_stacked(cfg)))
        self.final_norm = L.make_norm(cfg, device)

    def stack(self) -> list:
        """Every layer in the order the forward runs them: moe's dense
        `layer0` first, then `layers`."""
        first = [self.layer0] if hasattr(self, "layer0") else []
        return first + list(self.layers)

    def backbone(self, x: Tensor, positions: Tensor,
                 train: bool = False) -> Tensor:
        """x (B, S, d) embedded inputs -> final hidden states; with `train`
        and cfg.remat each layer is checkpointed (`_remat`)."""
        remat = train and self.cfg.remat
        for layer in self.stack():
            if remat:
                x = _remat(layer, x, positions, self.use_kernels)
            else:
                x = layer(x, positions, self.use_kernels)[0]
        return self.final_norm(x)

    def logits(self, tokens: Tensor, train: bool = False) -> Tensor:
        """tokens (B, S) -> logits (B, S, padded vocab)."""
        x = self.embed.apply_embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return self.embed.apply_unembed(self.backbone(x, positions, train))

    def loss_fn(self, batch: dict) -> Tensor:
        """Mean next-token cross-entropy of batch["tokens"] against
        batch["labels"], weighted by the optional batch["loss_mask"]."""
        logits = self.logits(batch["tokens"], train=True)
        return L.softmax_xent(logits, batch["labels"],
                              batch.get("loss_mask"))

    def forward(self, batch: dict) -> Tensor:
        """The training loss (`loss_fn`): what `torch.func.functional_call(
        model, params, (batch,))` evaluates at `params`."""
        return self.loss_fn(batch)


def n_stacked(cfg: ModelConfig) -> int:
    """Layers under `layers` (the reference's stacked axis): all of them
    but moe's dense first layer."""
    if cfg.family == "moe" and cfg.moe.first_layer_dense:
        return cfg.n_layers - 1
    return cfg.n_layers


def _remat(layer: nn.Module, x: Tensor, positions: Tensor,
           use_kernels: bool) -> Tensor:
    """One layer under `torch.utils.checkpoint` (non-reentrant): only x is
    kept, and the layer runs again in the backward pass. Its parameters
    go in as explicit inputs and the body binds them with
    `functional_call`, so the recomputation uses the tensors of this
    forward: under an outer `functional_call` the module's own attributes
    are restored before the backward runs. Only x is returned: training
    keeps no cache and no recurrent state."""
    names = [n for n, _ in layer.named_parameters()]
    tensors = [t for _, t in layer.named_parameters()]

    def body(h, *params):
        return functional_call(layer, dict(zip(names, params)),
                               (h, positions, use_kernels))[0]

    return checkpoint(body, x, *tensors, use_reentrant=False)
