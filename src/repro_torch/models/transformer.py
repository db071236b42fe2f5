"""Model assembly for the dense family: port of `repro.models.transformer`.

    Model(cfg, device, use_kernels=True)   -- an nn.Module holding the
        parameters under the reference's names (`embed`, `layers.<i>.*`,
        `final_norm`), one module per layer where the reference scans over
        layer-stacked parameters
    init_params(model, generator)          -- `models.decls`
    model.backbone(x, positions, train) / model.logits(tokens, train)
    model.loss_fn(batch) / model(batch)    -- the training loss; with
        `torch.func.functional_call(model, params, (batch,))` at `params`

The dense family (yi, qwen, gemma) is ported; building a Model for any
other family (moe, ssm, hybrid, encdec, vlm) raises NotImplementedError.
There is no `_constrain`: it is a mesh-sharding hint, and the port runs on
one card. With `train=True` and `cfg.remat` each layer is recomputed in
the backward pass (`torch.utils.checkpoint`, non-reentrant), as the
reference wraps its scanned layer body in `jax.checkpoint`: a layer keeps
only its input, and K6 runs twice a layer a step.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

PORTED_FAMILIES = ("dense",)


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.make_norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.mlp = L.MLP(cfg, device)

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


class Model(nn.Module):
    """A dense-family LM on `device` (cuda by default; "cpu" runs every
    kernel's plain version; "meta" allocates nothing, for counting).
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
        self.layers = nn.ModuleList(DenseLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.make_norm(cfg, device)

    def backbone(self, x: Tensor, positions: Tensor,
                 train: bool = False) -> Tensor:
        """x (B, S, d) embedded inputs -> final hidden states; with `train`
        and cfg.remat each layer is checkpointed (`_remat`)."""
        remat = train and self.cfg.remat
        for layer in self.layers:
            if remat:
                x = _remat(layer, x, positions, self.use_kernels)
            else:
                x, _, _ = layer(x, positions, self.use_kernels)
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


def _remat(layer: DenseLayer, x: Tensor, positions: Tensor,
           use_kernels: bool) -> Tensor:
    """One layer under `torch.utils.checkpoint` (non-reentrant): only x is
    kept, and the layer runs again in the backward pass. Its parameters
    go in as explicit inputs and the body binds them with
    `functional_call`, so the recomputation uses the tensors of this
    forward: under an outer `functional_call` the module's own attributes
    are restored before the backward runs. The layer's k and v are not
    returned: training keeps no cache."""
    names = [n for n, _ in layer.named_parameters()]
    tensors = [t for _, t in layer.named_parameters()]

    def body(h, *params):
        return functional_call(layer, dict(zip(names, params)),
                               (h, positions, use_kernels))[0]

    return checkpoint(body, x, *tensors, use_reentrant=False)
