"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6,
2 shared experts, first layer dense.  [arXiv:2405.04434; hf DeepSeek-V2-Lite]

Assignment-sheet note (also in DESIGN.md): the sheet's bracket text says
"160 routed" but its heading says "MoE 64e top-6"; HF DeepSeek-V2-Lite is 64
routed / top-6 / 2 shared, which we follow.  d_ff=1408 is the per-expert
(moe) intermediate size; the dense first layer uses 10944 (hf value).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    attn_type="mla",
    q_lora_rank=0,            # v2-lite: full-rank Q
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    attn_type="mla",
    kv_lora_rank=32,
    qk_rope_head_dim=8,
    qk_nope_head_dim=16,
    v_head_dim=16,
    n_experts=8,
    experts_per_tok=2,
    n_shared_experts=2,
    moe_d_ff=32,
    first_dense_layers=1,
    dtype="float32",
    remat=False,
)
