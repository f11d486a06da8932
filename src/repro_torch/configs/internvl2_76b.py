"""internvl2-76b [vlm] — 80L LM backbone (Hermes-2-Llama-3.1-70B-class dims).
[arXiv:2404.16821; unverified]

The InternViT-6B vision frontend is a STUB per the assignment: input_specs()
provides precomputed patch embeddings [B, 256, D] prepended to the token
sequence in train/prefill.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp_type="swiglu",
    rope_theta=500000.0,
    frontend="vision",
    frontend_seq=256,
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    frontend="vision",
    frontend_seq=8,
    dtype="float32",
    remat=False,
)
