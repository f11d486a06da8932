"""Synthetic data pipelines of the port (numpy, device-free)."""
from repro_torch.data.pipeline import (
    CifarLikePipeline,
    DVSEventPipeline,
    KWSSpectrogramPipeline,
    LMTokenPipeline,
    PipelineState,
    pipeline_for,
    pipeline_for_net,
)

__all__ = [
    "CifarLikePipeline", "DVSEventPipeline", "KWSSpectrogramPipeline",
    "LMTokenPipeline", "PipelineState", "pipeline_for", "pipeline_for_net",
]
