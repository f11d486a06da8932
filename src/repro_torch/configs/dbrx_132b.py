"""dbrx-132b [moe] — 40L, 16 experts top-4 fine-grained MoE, GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_tok=4,
    moe_d_ff=10752,
    mlp_type="swiglu",
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    experts_per_tok=2,
    moe_d_ff=64,
    dtype="float32",
    remat=False,
)
