"""qwen2.5-32b [dense] — 64L GQA kv=8, QKV bias.  [hf:Qwen/Qwen2.5; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
    remat=False,
)
