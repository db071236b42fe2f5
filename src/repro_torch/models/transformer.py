"""Model assembly: port of `repro.models.transformer`, every family:
dense (yi, qwen, gemma), vlm (pixtral: patch embeddings prepended to the
tokens), moe (deepseek, grok), ssm (falcon-mamba), hybrid
(recurrentgemma: (rec, rec, attn) triples with a sliding window in the
attention layer, then tail rec layers) and encdec (whisper: an encoder
over frame embeddings, a causal decoder with cross-attention).

    Model(cfg, device, use_kernels=True)   -- an nn.Module holding the
        parameters under the reference's names (`embed`, `layers.<i>.*`,
        moe's dense `layer0`, hybrid's `triples.<i>.{rec1,rec2,attn}` and
        `tail_rec<j>`, encdec's `enc_layers.<i>`, `enc_norm`,
        `dec_layers.<i>`; `final_norm`), one module per layer where the
        reference scans over layer-stacked parameters
    init_params(model, generator)          -- `models.decls`
    model.backbone(x, positions, train) / model.logits(tokens, train,
        patches=, frames=) / model.encode(frames)
    model.loss_fn(batch) / model(batch)    -- the training loss; with
        `torch.func.functional_call(model, params, (batch,))` at `params`

A layer is a module whose forward(x, positions, use_kernels) returns the
new x first: a DenseLayer or MoELayer its rotated k and v after it (the
prefill's cache), an SSMLayer or RecLayer its recurrent state, a
DecoderLayer (which also takes the encoder's output) its self-attention's
k and v and its cross-attention's. There is no `_constrain`: it is a
sharding hint to XLA, and the port's sharded train step places the batch
and the parameters itself (`train.steps`, `models.sharding`). Inside
`model.split_compute(split)` (a `sharding.Split` along "model") the
backbone, the logits and `loss_fn` compute each rank's share, as the
reference's rules place it, on the "model" blocks bound by
`functional_call`; decode and prefill never run split.
With `train=True` and `cfg.remat` each layer is recomputed in the
backward pass (`torch.utils.checkpoint`, non-reentrant), as the
reference wraps its scanned layer body in `jax.checkpoint`: a layer keeps
only its input, and K6 runs twice an attention layer a step. Inside
`model.gathering(gather)` (a `sharding.DataGather`: FSDP over the data
axes) each layer's body first gathers the layer's blocks, so the forward
and the recompute each hold one layer's whole weights at a time.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import decls
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


class DenseLayer(nn.Module):
    """Attention then an MLP of `d_ff` (the config's by default): the
    dense and vlm families' layer, deepseek's dense first layer, the
    hybrid's attention layer (`window`: the config's `attn_window` by
    default) and whisper's encoder layer (`causal=False`; its MLP has
    biases)."""

    def __init__(self, cfg: ModelConfig, device, d_ff: int = 0,
                 window: int | None = None, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.window = cfg.attn_window if window is None else window
        self.causal = causal
        self.norm1 = L.make_norm(cfg, device)
        self.attn = attn.Attention(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.mlp = L.MLP(cfg, device, d_ff=d_ff,
                         bias=cfg.family == "encdec")

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool):
        """-> (x after the layer, the layer's rotated k and its v)."""
        h, k, v = attn.attend_full(self.cfg, self.attn, self.norm1(x),
                                   positions, causal=self.causal,
                                   window=self.window,
                                   use_kernels=use_kernels)
        x = x + h
        return x + self.mlp(self.norm2(x)), k, v

    def decode(self, x: Tensor, cache: attn.KVCache):
        h, cache = attn.decode_step(self.cfg, self.attn, self.norm1(x), cache,
                                    window=self.window)
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


class RecLayer(nn.Module):
    """The hybrid's recurrent layer: a norm and the RG-LRU block with a
    residual, then a norm and the MLP with a residual."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.make_norm(cfg, device)
        self.rec = rglru.RGLRU(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.mlp = L.MLP(cfg, device)

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool):
        """-> (x after the layer, the block's state after the sequence).
        positions and use_kernels are unused (no attention)."""
        h, state = rglru.apply_rglru_block(self.cfg, self.rec, self.norm1(x))
        x = x + h
        return x + self.mlp(self.norm2(x)), state

    def decode(self, x: Tensor, state: rglru.LRUState):
        h, state = rglru.rglru_decode_step(self.cfg, self.rec,
                                           self.norm1(x), state)
        x = x + h
        return x + self.mlp(self.norm2(x)), state


class Triple(nn.Module):
    """One (rec, rec, attn) period of the hybrid stack: the reference's
    `triples` leaf; its attention layer has the config's window."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.rec1 = RecLayer(cfg, device)
        self.rec2 = RecLayer(cfg, device)
        self.attn = DenseLayer(cfg, device, window=cfg.hybrid.window)


class DecoderLayer(nn.Module):
    """Whisper's decoder layer: causal self-attention, cross-attention onto
    the encoder's output, then the MLP (with biases), each after a
    layernorm and with a residual."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.make_norm(cfg, device)
        self.self_attn = attn.Attention(cfg, device)
        self.norm_x = L.make_norm(cfg, device)
        self.cross_attn = attn.Attention(cfg, device)
        self.norm2 = L.make_norm(cfg, device)
        self.mlp = L.MLP(cfg, device, bias=True)

    def forward(self, x: Tensor, positions: Tensor, use_kernels: bool,
                enc_out: Tensor):
        """-> (x after the layer, the self-attention's k and v, the
        cross-attention's k and v: the decode cache's)."""
        h, k, v = attn.attend_full(self.cfg, self.self_attn, self.norm1(x),
                                   positions, causal=True,
                                   use_kernels=use_kernels)
        x = x + h
        h, ck, cv = attn.attend_full(self.cfg, self.cross_attn,
                                     self.norm_x(x), positions, causal=False,
                                     use_kernels=use_kernels, kv_x=enc_out)
        x = x + h
        return x + self.mlp(self.norm2(x)), k, v, ck, cv

    def decode(self, x: Tensor, cache: attn.KVCache, ck: Tensor,
               cv: Tensor):
        h, cache = attn.decode_step(self.cfg, self.self_attn, self.norm1(x),
                                    cache)
        x = x + h
        x = x + attn.cross_decode(self.cross_attn, self.norm_x(x), ck, cv)
        return x + self.mlp(self.norm2(x)), cache


class Model(nn.Module):
    """An LM of any family on `device` (cuda by default; "cpu" runs
    every kernel's plain version; "meta" allocates nothing, for counting).
    Parameters are uninitialised until `init_params` or a load.
    `use_kernels=False` sends the blockwise attention route to K6's plain
    version even on the card (the smoke run's agreement check)."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 use_kernels: bool = True):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: no {cfg.family!r} family; the port has "
                f"{PORTED_FAMILIES} (ROADMAP Queue 1 item 6)")
        device = torch.device(device)
        if device.type != "meta":
            device = resolve_device(device)
        self.cfg = cfg
        self.device = device
        self.use_kernels = use_kernels
        n = stacked_layers(cfg)
        # registered in the reference's declaration order: init_params
        # draws in it
        self.embed = L.Embed(cfg, device)
        if cfg.family == "moe" and cfg.moe.first_layer_dense:
            self.layer0 = DenseLayer(cfg, device, d_ff=cfg.moe.d_ff_dense)
        if "layers" in n:
            layer = {"dense": DenseLayer, "vlm": DenseLayer, "moe": MoELayer,
                     "ssm": SSMLayer}[cfg.family]
            self.layers = nn.ModuleList(layer(cfg, device)
                                        for _ in range(n["layers"]))
        elif cfg.family == "hybrid":
            self.triples = nn.ModuleList(Triple(cfg, device)
                                         for _ in range(n["triples"]))
            for j in range(cfg.n_layers - 3 * n["triples"]):
                setattr(self, f"tail_rec{j}", RecLayer(cfg, device))
        else:
            self.enc_layers = nn.ModuleList(
                DenseLayer(cfg, device, causal=False)
                for _ in range(n["enc_layers"]))
            self.enc_norm = L.make_norm(cfg, device)
            self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device)
                                            for _ in range(n["dec_layers"]))
        self.final_norm = L.make_norm(cfg, device)
        self.data_gather = None

    @contextlib.contextmanager
    def gathering(self, gather):
        """Inside the block each layer's body binds its parameters
        through `gather.bind` (a `sharding.DataGather`; None: as they
        are, as outside)."""
        self.data_gather = gather
        try:
            yield
        finally:
            self.data_gather = None

    @contextlib.contextmanager
    def split_compute(self, split):
        """Inside the block every module computes its share along "model"
        of `split` (a `sharding.Split`; None: whole, as outside)."""
        mods = [m for m in self.modules() if isinstance(m, decls.Declared)]
        for m in mods:
            m.split = split
        try:
            yield
        finally:
            for m in mods:
                m.split = None

    def tails(self) -> list:
        """The hybrid's tail rec layers, `tail_rec0`, `tail_rec1`, ..."""
        out = []
        while hasattr(self, f"tail_rec{len(out)}"):
            out.append(getattr(self, f"tail_rec{len(out)}"))
        return out

    def stack(self) -> list:
        """Every layer of the backbone in the order the forward runs them:
        moe's dense `layer0` first, then `layers`; the hybrid's triples
        (rec1, rec2, attn each), then its tail; encdec's decoder layers
        (the encoder is `encode`)."""
        if self.cfg.family == "hybrid":
            return [m for t in self.triples
                    for m in (t.rec1, t.rec2, t.attn)] + self.tails()
        if self.cfg.family == "encdec":
            return list(self.dec_layers)
        first = [self.layer0] if hasattr(self, "layer0") else []
        return first + list(self.layers)

    def layers_run(self) -> list:
        """Every layer a step runs: encdec's encoder layers, then
        `stack()`."""
        enc = list(self.enc_layers) if self.cfg.family == "encdec" else []
        return enc + self.stack()

    def _layer(self, layer: nn.Module, x: Tensor, positions: Tensor,
               remat: bool, *extra: Tensor) -> Tensor:
        """x after `layer`. With `remat` (checkpointed) or inside
        `gathering` its parameters go in as explicit inputs and a body
        binds them with `functional_call`, gathered first through
        `gather.bind` inside `gathering`. Under `torch.utils.checkpoint`
        (non-reentrant) only x (and `extra`, the encoder's output for a
        decoder layer) is kept, and the body runs again in the backward
        on the tensors of this forward: under an outer `functional_call`
        the module's own attributes are restored before the backward
        runs. So with a gather the forward frees the whole weights and
        the recompute gathers them again, as `jax.checkpoint` does. Only
        x is returned: training keeps no cache and no recurrent
        state."""
        gather, use_kernels = self.data_gather, self.use_kernels
        if not remat and gather is None:
            return layer(x, positions, use_kernels, *extra)[0]
        names = [n for n, _ in layer.named_parameters()]
        tensors = [t for _, t in layer.named_parameters()]
        k = len(extra)

        def body(h, *args):
            params = dict(zip(names, args[k:]))
            if gather is not None:
                params = gather.bind(layer, params)
            return functional_call(layer, params,
                                   (h, positions, use_kernels, *args[:k]))[0]

        if remat:
            return checkpoint(body, x, *extra, *tensors, use_reentrant=False)
        return body(x, *extra, *tensors)

    def backbone(self, x: Tensor, positions: Tensor, train: bool = False,
                 enc_out: Tensor | None = None) -> Tensor:
        """x (B, S, d) embedded inputs -> final hidden states (encdec: the
        decoder's, over the encoder's output `enc_out`); with `train` and
        cfg.remat each layer is checkpointed (`_layer`)."""
        remat = train and self.cfg.remat
        extra = () if enc_out is None else (enc_out,)
        for layer in self.stack():
            x = self._layer(layer, x, positions, remat, *extra)
        return self.final_norm(x)

    def encode(self, frames: Tensor, train: bool = False) -> Tensor:
        """Whisper's encoder over frame embeddings (B, F, d): sinusoidal
        positions added, non-causal layers, a final norm."""
        F = frames.shape[1]
        pos = L.sinusoidal_positions(F, self.cfg.d_model).to(frames.device)
        x = frames + pos[None].to(frames.dtype)
        positions = torch.arange(F, device=frames.device)
        remat = train and self.cfg.remat
        for layer in self.enc_layers:
            x = self._layer(layer, x, positions, remat)
        return self.enc_norm(x)

    def embed_inputs(self, tokens: Tensor, patches: Tensor | None = None,
                     frames: Tensor | None = None, train: bool = False):
        """-> (x (B, S', d), positions (S',), the encoder's output or None):
        the embedded tokens, after vlm's patch embeddings (S' = n_patches +
        S), or with encdec's sinusoids added and the frames encoded."""
        x = self.embed.apply_embed(tokens)
        enc_out = None
        if self.cfg.family == "vlm":
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        elif self.cfg.family == "encdec":
            enc_out = self.encode(frames, train)
            pos = L.sinusoidal_positions(x.shape[1], self.cfg.d_model)
            x = x + pos.to(x.device)[None].to(x.dtype)
        positions = torch.arange(x.shape[1], device=tokens.device)
        return x, positions, enc_out

    def logits(self, tokens: Tensor, train: bool = False,
               patches: Tensor | None = None,
               frames: Tensor | None = None) -> Tensor:
        """tokens (B, S) -> logits (B, S', padded vocab): vlm's cover the
        patches too (S' = n_patches + S), as the reference's do."""
        x, positions, enc_out = self.embed_inputs(tokens, patches, frames,
                                                  train)
        return self.embed.apply_unembed(
            self.backbone(x, positions, train, enc_out))

    def loss_fn(self, batch: dict, total: Tensor | None = None) -> Tensor:
        """Mean next-token cross-entropy of batch["tokens"] (with vlm's
        "patches", encdec's "frames") against batch["labels"], weighted by
        the optional batch["loss_mask"]; with `total`, these rows' share
        of a batch split over data shards (`layers.softmax_xent`)."""
        logits = self.logits(batch["tokens"], train=True,
                             patches=batch.get("patches"),
                             frames=batch.get("frames"))
        return L.softmax_xent(logits, batch["labels"],
                              batch.get("loss_mask"), total,
                              split=self.embed.vocab_split())

    def forward(self, batch: dict, total: Tensor | None = None) -> Tensor:
        """The training loss (`loss_fn`): what `torch.func.functional_call(
        model, params, (batch,), {"total": ...})` evaluates at
        `params`."""
        return self.loss_fn(batch, total)


def stacked_layers(cfg: ModelConfig) -> dict:
    """The reference's layer-stacked leaves and their lengths: `layers`
    (all of dense's, vlm's and ssm's layers, moe's but its dense first
    layer), hybrid's `triples` (n_layers // 3; the rest are tail rec
    layers), encdec's `enc_layers` and `dec_layers`."""
    if cfg.family == "hybrid":
        return {"triples": cfg.n_layers // 3}
    if cfg.family == "encdec":
        return {"enc_layers": cfg.encdec.n_encoder_layers,
                "dec_layers": cfg.n_layers}
    if cfg.family == "moe" and cfg.moe.first_layer_dense:
        return {"layers": cfg.n_layers - 1}
    return {"layers": cfg.n_layers}


