"""Observability of the port: so far only the fixed-bucket latency
histogram the serving batcher and loop report p50/p99 from."""
from repro_torch.obs.registry import LATENCY_BOUNDS_S, Histogram

__all__ = ["Histogram", "LATENCY_BOUNDS_S"]
