"""Deterministic synthetic token pipeline with per-host sharding and
prefetch: the data plane the trainer consumes.  The port of
``repro.train.data``.

Every batch is a pure function of (seed, host, step), drawn with the
reference's numpy code, so its tokens are bit for bit the reference's and
a resumed run sees the batches an uninterrupted one would.  ``batch_at``
returns int32 CPU tensors; the trainer moves them to its device.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticLM:
    """Markov-ish token stream: next token = f(prev, position, stream seed).
    Cheap, deterministic, and non-degenerate (loss can actually decrease)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab
        self.seq = seq_len
        self.batch = global_batch // n_hosts
        self.seed = seed
        self.host = host_id

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host, step]))
        base = rng.integers(0, self.vocab, (self.batch, 1), dtype=np.int64)
        pos = np.arange(self.seq + 1, dtype=np.int64)[None, :]
        # deterministic pseudo-structure + noise
        toks = (base + pos * 2654435761 % 97) % self.vocab
        noise = rng.integers(0, self.vocab, toks.shape)
        mask = rng.random(toks.shape) < 0.1
        toks = np.where(mask, noise, toks).astype(np.int32)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                "targets": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}


class Prefetcher:
    """Background prefetch of up to ``depth`` batches (straggler decoupling).
    The thread starts here and stops at ``close``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
