"""Deterministic sharded synthetic token pipeline with prefetch.

Generates a reproducible Zipf-ish token stream (a fixed xorshift PRNG per
(seed, shard, step), so any host can regenerate any shard independently —
the property a 1000-node data pipeline needs for elastic membership and
restart-from-step-k without coordination).  A background thread prefetches
``prefetch`` batches ahead.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["Batch", "SyntheticLM"]


@dataclass
class Batch:
    tokens: np.ndarray        # (A, B, S_tok) int32
    labels: np.ndarray        # (A, B, S) int32
    prefix: np.ndarray | None  # (A, B, F, d) bf16-compatible f32
    step: int


class SyntheticLM:
    """Iterable over training batches.

    ``shard`` / ``n_shards`` slice the global batch for multi-host use:
    every host generates only its rows, deterministically.
    """

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 accum: int = 1, frontend_len: int = 0, d_model: int = 0,
                 seed: int = 0, shard: int = 0, n_shards: int = 1,
                 start_step: int = 0, prefetch: int = 2) -> None:
        assert global_batch % (accum * n_shards) == 0
        self.vocab = vocab
        self.seq = seq_len
        self.accum = accum
        self.rows = global_batch // accum // n_shards
        self.frontend_len = frontend_len
        self.d_model = d_model
        self.seed = seed
        self.shard = shard
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic generation ----------------------------------------

    def _rng(self, step: int) -> np.random.Generator:
        key = (self.seed * 0x9E3779B9 + step * 0x85EBCA6B
               + self.shard * 0xC2B2AE35) & 0xFFFFFFFF
        return np.random.default_rng(key)

    def _make(self, step: int) -> Batch:
        rng = self._rng(step)
        A, B = self.accum, self.rows
        S = self.seq
        F = self.frontend_len
        S_tok = S - F
        # Zipf-ish marginal: squared-uniform maps toward low token ids.
        u = rng.random((A, B, S_tok), dtype=np.float32)
        tokens = (u * u * (self.vocab - 1)).astype(np.int32)
        labels = np.concatenate(
            [np.full((A, B, F), -1, np.int32),
             np.roll(tokens, -1, axis=-1)], axis=-1) if F else \
            np.roll(tokens, -1, axis=-1)
        labels[..., -1] = -1          # no next-token for the last position
        prefix = None
        if F:
            prefix = rng.standard_normal(
                (A, B, F, self.d_model), dtype=np.float32) * 0.02
        return Batch(tokens=tokens, labels=labels, prefix=prefix,
                     step=step)

    # -- prefetch thread ----------------------------------------------------

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
