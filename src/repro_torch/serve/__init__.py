"""Sparse-model serving of the port: the training-to-traffic path for the
solver's l1 solutions (port of `repro.serve`).

  * `serve.artifact` -- the on-disk model format, the same
    `repro.serve/model@1` JSON as the JAX package's, so a model saved by
    either package loads in the other.
  * `serve.predict`  -- batched-margin prediction over the stacked
    active-coordinate `ModelBank`, with the hand-written CUDA kernels K4a
    (dense requests) and K4b (padded-CSC requests), and crossover routing
    between the union-gather and densified-matmul scorers.
  * `serve.policy`   -- shared bucket geometry and the per-bucket latency
    model behind the deadline math.
  * `serve.batcher`  -- synchronous microbatching front-end.
  * `serve.loop`     -- continuous-batching serving loop: request queue,
    deadline-aware flushing, multi-model routing, hot-swap in place into
    capacity-padded banks.

Not here yet: `serve.ovr` (one-vs-rest training), which trains through the
batch solver of the path slice; an OVR artifact saved by the JAX package is
served all the same. `scorer_cache_sizes` has no counterpart (see
`serve.predict`).
"""
from repro_torch.serve.artifact import (SCHEMA, ModelArtifact, ModelFamily,
                                        artifact_from_solution, load_model,
                                        path_family, pick_best_c, save_model,
                                        solver_provenance)
from repro_torch.serve.batcher import BucketStats, MicroBatcher
from repro_torch.serve.loop import (ServeFuture, ServeLoop, ServeOverload,
                                    ServeResult, SlotQuarantined,
                                    SwapCapacityError, drive_poisson)
from repro_torch.serve.policy import (BucketPolicy, LatencyModel,
                                      default_buckets)
from repro_torch.serve.predict import (ModelBank, decide, margins_dense,
                                       margins_padded_csc, pick_route, predict,
                                       route_crossover, set_route_crossover)

__all__ = [
    "SCHEMA", "ModelArtifact", "ModelFamily", "artifact_from_solution",
    "save_model", "load_model", "path_family", "pick_best_c",
    "solver_provenance",
    "ModelBank", "margins_dense", "margins_padded_csc", "predict", "decide",
    "pick_route", "route_crossover", "set_route_crossover",
    "MicroBatcher", "BucketStats", "default_buckets",
    "BucketPolicy", "LatencyModel",
    "ServeLoop", "ServeFuture", "ServeResult", "ServeOverload",
    "SlotQuarantined", "SwapCapacityError", "drive_poisson",
]
