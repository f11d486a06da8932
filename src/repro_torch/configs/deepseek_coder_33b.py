"""deepseek-coder-33b [dense] — 62L llama-arch, GQA kv=8.
[arXiv:2401.14196; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    mlp_type="swiglu",
    rope_theta=100000.0,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    remat=False,
)
