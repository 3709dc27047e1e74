"""Deterministic synthetic data pipeline with host prefetch: the port's
copy of ``repro.data.pipeline`` (numpy only, line for line).

Synthesizes a structured LM stream (Zipf-distributed tokens + periodic
copy-motifs so that loss has learnable signal) with per-(step, host) seeding,
so any host regenerates exactly its shard: restart safe by construction (no
data state to checkpoint beyond the step counter).  Batches stay numpy; the
launcher moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_period: int = 64      # every k-th position repeats a motif token
    frontend_tokens: int = 0    # VLM/audio stub embeddings
    frontend_dim: int = 0


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0, (cfg.global_batch, n_hosts)
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> dict:
        """The batch for ``step`` — identical regardless of when/where asked."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        shape = (self.local_batch, cfg.seq_len + 1)
        tokens = rng.choice(cfg.vocab_size, size=shape, p=self._probs)
        # inject copy-motifs: position p copies position p - period
        if cfg.motif_period:
            p = cfg.motif_period
            tokens[:, p::p] = tokens[:, : tokens.shape[1] - p : p][:, : tokens[:, p::p].shape[1]]
        out = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if cfg.frontend_tokens:
            out["frontend_emb"] = rng.standard_normal(
                (self.local_batch, cfg.frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of upcoming batches."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)


def make_pipeline(cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                  start_step: int = 0, prefetch: int = 2):
    src = SyntheticLM(cfg, host_id, n_hosts)
    if prefetch:
        return Prefetcher(src, start_step=start_step, depth=prefetch)
    return src
