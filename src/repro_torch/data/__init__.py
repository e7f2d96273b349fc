"""Data pipelines of the port (``repro.data``)."""

from repro_torch.data.pipeline import LMDataPipeline, SegDataPipeline

__all__ = ["LMDataPipeline", "SegDataPipeline"]
