"""glm4-9b [dense] — 40L, GQA kv=2, partial RoPE.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    partial_rotary_factor=0.5,
    mlp_type="swiglu",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    partial_rotary_factor=0.5,
    dtype="float32",
    remat=False,
)
