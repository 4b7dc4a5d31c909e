"""Synthetic LM data pipeline: deterministic token streams with document
packing, sharding-aware batching, and background prefetch.

Real deployments swap ``SyntheticSource`` for a tokenized corpus reader; the
pipeline contract (pack -> batch -> shard -> prefetch) is what the trainer
depends on, and is exercised end-to-end by the examples and tests.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticSource:
    """Zipfian token documents with EOS separation (deterministic by seed)."""

    def __init__(self, vocab: int, seed: int = 0, mean_doc_len: int = 512):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.mean_doc_len = mean_doc_len

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            n = max(8, int(self.rng.exponential(self.mean_doc_len)))
            # zipf-ish distribution over the vocab, clipped
            toks = self.rng.zipf(1.3, size=n) % (self.vocab - 2)
            yield toks.astype(np.int32) + 2  # reserve 0=pad, 1=eos


class PackedBatcher:
    """Greedy document packing into fixed (batch, seq) windows."""

    def __init__(self, source, batch: int, seq: int, eos: int = 1):
        self.source = iter(source)
        self.batch = batch
        self.seq = seq
        self.eos = eos
        self._buf = np.empty((0,), np.int32)

    def _fill(self, n: int) -> np.ndarray:
        while len(self._buf) < n:
            doc = next(self.source)
            self._buf = np.concatenate(
                [self._buf, doc, np.asarray([self.eos], np.int32)]
            )
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = self.batch * (self.seq + 1)
        while True:
            flat = self._fill(n).reshape(self.batch, self.seq + 1)
            yield {"tokens": flat[:, :-1], "labels": flat[:, 1:]}


class Prefetcher:
    """Background-thread prefetch (the host-side input pipeline overlap)."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = iter(it)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err or StopIteration
        return item


def make_pipeline(
    vocab: int, batch: int, seq: int, seed: int = 0, prefetch: int = 2
):
    src = SyntheticSource(vocab, seed)
    batched = PackedBatcher(src, batch, seq)
    return Prefetcher(batched, depth=prefetch)
