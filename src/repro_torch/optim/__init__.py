"""Optimizer substrate of the port: a copy of `repro.optim` on dicts of
tensors (the parameter dicts `torch.func.functional_call` takes)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.compression import topk_compress_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup_cosine", "topk_compress_update"]
