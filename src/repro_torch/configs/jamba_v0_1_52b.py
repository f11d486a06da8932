"""jamba-v0.1-52b [hybrid] — 32L, attn:mamba 1:7 interleave (period 8,
attention at in-block offset 4), MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]

DESIGN.md §Arch-applicability: jamba v0.1 uses mamba*1* layers; we run SSD
(mamba2) blocks at jamba's dims (state=16, conv=4, expand=2) — same
asymptotics, single well-tested scan.  This arch runs the long_500k cell
(sub-quadratic: only 4/32 layers are attention).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_layer_period=8,
    attn_layer_offset=4,
    mlp_type="swiglu",
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    experts_per_tok=2,
    moe_d_ff=64,
    moe_layer_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    attn_layer_period=4,
    attn_layer_offset=2,
    dtype="float32",
    remat=False,
)
