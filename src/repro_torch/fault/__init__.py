"""Fault tolerance of the port: only the atomic writes the serve artifacts
need so far (`fault.atomic`); checkpoints, injection and resilient solves
come with their own slice."""
from repro_torch.fault.atomic import atomic_write_json

__all__ = ["atomic_write_json"]
