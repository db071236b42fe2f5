"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device, refusing CUDA when no card is present.

    Nothing falls back to the CPU by itself: a caller that wants the CPU
    says so (`device="cpu"`), as the tests do.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(t: torch.Tensor) -> None:
    """Wait for the device that holds `t` (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
