"""Deterministic synthetic segmentation batches for ENet.

The port of ``repro.data.pipeline.SegDataPipeline``: pure numpy, a batch is
a function of ``(seed, step)`` alone, so the port trains on the reference's
batches bit for bit.  ``LMDataPipeline`` comes with the LM scaffolding
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import numpy as np


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


__all__ = ["SegDataPipeline"]
