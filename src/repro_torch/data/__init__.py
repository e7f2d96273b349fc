"""Data pipelines of the port (``repro.data``)."""

from repro_torch.data.pipeline import SegDataPipeline

__all__ = ["SegDataPipeline"]
