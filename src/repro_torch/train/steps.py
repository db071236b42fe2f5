"""Serving-step factories: port of `repro.train.steps`'s `make_serve_step`
and `make_prefill_step`. The parameters live in the model, so the steps
take no params argument. `make_train_step`, the optimizer-state specs and
the cache sharding specs come with the training and multi-card slices."""
from __future__ import annotations

from repro_torch.models import decode as dec
from repro_torch.models.transformer import Model


def make_serve_step(model: Model):
    """-> serve_step(cache, tokens) -> (logits, cache): one greedy decode
    step for the whole request batch."""
    def serve_step(cache, tokens):
        return dec.decode_step(model, cache, tokens)
    return serve_step


def make_prefill_step(model: Model):
    """-> prefill_step(batch) -> logits (B, S, V) over the whole prompt."""
    def prefill_step(batch):
        return model.logits(batch["tokens"])
    return prefill_step
