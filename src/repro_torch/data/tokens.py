"""LM token pipeline: deterministic synthetic corpus + background prefetch.
A copy of `repro.data.tokens` (numpy only) on the port's `ModelConfig`:
`batch_at(i)` is bit-equal to the reference's for the same seed and index.

No corpus ships with the repository: the stream is a seeded Markov-ish
token generator (enough structure that loss visibly drops during the
example run). The pipeline is restart-deterministic: batch k is a pure
function of (seed, k), so checkpoint resume replays the exact stream —
the property the fault-tolerance tests assert.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.prefetch = prefetch

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, index): restart-deterministic."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index]))
        V = self.cfg.vocab_size
        B, S = self.batch, self.seq
        # structured stream: piecewise-linear token ramps + noise, so a
        # model can learn next-token structure quickly
        base = rng.integers(0, V, size=(B, 1))
        step = rng.integers(1, 7, size=(B, 1))
        ramp = (base + step * np.arange(S + 1)[None, :]) % V
        noise = rng.integers(0, V, size=(B, S + 1))
        keep = rng.random((B, S + 1)) < 0.85
        toks = np.where(keep, ramp, noise).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            npatch = self.cfg.vlm.n_patches
            out["patches"] = rng.standard_normal(
                (B, npatch, self.cfg.d_model)).astype(np.float32) * 0.02
            out["labels"] = np.concatenate(
                [np.zeros((B, npatch), np.int32), out["labels"]], axis=1)
            out["loss_mask"] = np.concatenate(
                [np.zeros((B, npatch), np.float32),
                 np.ones((B, S), np.float32)], axis=1)
        if self.cfg.family == "encdec":
            fr = self.cfg.encdec.encoder_frames
            out["frames"] = rng.standard_normal(
                (B, fr, self.cfg.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(start=0)

    def iterate(self, start: int = 0,
                stop: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetch (double buffering)."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop_flag = threading.Event()

        def producer():
            i = start
            while not stop_flag.is_set() and (stop is None or i < stop):
                q.put((i, self.batch_at(i)))
                i += 1
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item[1]
        finally:
            stop_flag.set()
