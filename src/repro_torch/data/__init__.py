"""Synthetic data pipelines of the port (numpy, device-free)."""
from repro_torch.data.pipeline import DVSEventPipeline, PipelineState

__all__ = ["DVSEventPipeline", "PipelineState"]
