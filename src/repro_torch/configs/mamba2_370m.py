"""mamba2-370m [ssm] — 48L attention-free SSD, state=128.
[arXiv:2405.21060; unverified]

Runs the long_500k cell (O(1)-state decode).  With use_tcn_mapping=True the
depthwise conv1d executes through the paper's §4 dilated->2D mapping.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
