"""Synthetic data pipelines of the port (numpy, device-free)."""
from repro_torch.data.pipeline import (
    CifarLikePipeline,
    DVSEventPipeline,
    KWSSpectrogramPipeline,
    PipelineState,
    pipeline_for_net,
)

__all__ = [
    "CifarLikePipeline", "DVSEventPipeline", "KWSSpectrogramPipeline",
    "PipelineState", "pipeline_for_net",
]
