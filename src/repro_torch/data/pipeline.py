"""Deterministic synthetic data pipelines: LM token streams and
segmentation batches.

The port of ``repro.data.pipeline``: pure numpy, a batch is a function of
``(seed, step)`` (and, for the LM stream, the process index) alone, so the
port trains on the reference's batches bit for bit and a restart
reproduces the exact stream.  :class:`LMDataPipeline` keeps ``prefetch``
batches ready on a background thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class LMDataPipeline:
    """Synthetic LM token stream: (tokens, labels, mask) of (B, S), tokens
    and labels int32, the mask fp32 ones.

    Each process makes its own slice of the global batch
    (``process_index`` of ``process_count``; 0 of 1 by default: the port
    runs one process).  ``next(pipe)`` returns ``(step, batch)`` from the
    prefetch thread; :meth:`seek` restarts the stream at a step;
    :meth:`close` stops the thread.
    """

    def __init__(self, global_batch: int, seq_len: int, vocab: int,
                 seed: int = 0, prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {process_count} processes")
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed
        self.pidx, self.pcount = process_index, process_count
        self.local_batch = global_batch // process_count
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, process): restart-reproducible."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.pidx]))
        toks = rng.integers(0, self.vocab,
                            (self.local_batch, self.seq_len + 1),
                            dtype=np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((self.local_batch, self.seq_len), np.float32),
        }

    def _producer(self):
        while not self._stop.is_set():
            batch = self.batch_at(self._step)
            try:
                self._q.put((self._step, batch), timeout=1.0)
                self._step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def seek(self, step: int):
        """Restart the stream at ``step`` (checkpoint resume)."""
        self._stop.set()
        self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()
        self._step = step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join()


class SegDataPipeline:
    """Synthetic Cityscapes-like segmentation batches for ENet."""

    def __init__(self, batch: int, hw: int = 512, classes: int = 19,
                 seed: int = 0):
        self.batch, self.hw, self.classes, self.seed = batch, hw, classes, seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        img = rng.normal(size=(self.batch, self.hw, self.hw, 3)
                         ).astype(np.float32)
        # piecewise-constant label regions (more segmentation-like than
        # iid); the region size shrinks with hw so tiny inputs still get
        # labels, and the cell count ceils so non-multiples of 32 cover
        # the whole map
        cell = min(32, self.hw)
        n_cells = -(-self.hw // cell)
        coarse = rng.integers(0, self.classes, (self.batch, n_cells, n_cells))
        lbl = np.repeat(np.repeat(coarse, cell, axis=1), cell, axis=2)
        return {"image": img,
                "label": lbl[:, :self.hw, :self.hw].astype(np.int32)}


__all__ = ["LMDataPipeline", "SegDataPipeline"]
