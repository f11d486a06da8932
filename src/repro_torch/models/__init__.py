"""`repro_torch.models` — the LM stack of the port, counterpart of
`repro.models`: one model definition for the ten architectures of
`repro_torch.configs` (dense/GQA/MLA transformers, MoE, Mamba2 SSD, the
jamba hybrid, encoder-decoder and stub-fronted multimodal backbones), in the
reference's functional form over a params dict with the reference's paths
and leaf order.  It serves (``forward`` in modes ``train``, ``prefill`` and
``decode``) and trains (``lm_loss``, the sequence-chunked cross-entropy).
``cutie_net`` is the legacy CUTIE network shim.
"""
from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES
from repro_torch.models.model import (
    init_params,
    forward,
    lm_loss,
    cache_spec,
    init_cache,
    build_segments,
    ModelOutput,
)
