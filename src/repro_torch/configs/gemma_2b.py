"""gemma-2b [dense] — 18L, MQA (kv=1), GeGLU, head_dim=256, tied embeddings,
sqrt(d_model) embedding scale.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    dtype="float32",
    remat=False,
)
