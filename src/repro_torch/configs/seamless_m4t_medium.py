"""seamless-m4t-medium [audio] — 12L enc-dec transformer backbone.
[arXiv:2308.11596; hf]

The modality frontend (w2v-BERT conformer) is a STUB per the assignment:
input_specs() provides precomputed audio frame embeddings [B, S_enc, D]
feeding the text-less encoder; the decoder consumes text tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder
    n_enc_layers=12,        # encoder
    enc_seq_len=1024,       # stub audio frames (~20 s at 50 Hz)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    norm_type="layernorm",
    mlp_type="gelu",
    mlp_bias=True,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    enc_seq_len=16,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    norm_type="layernorm",
    mlp_type="gelu",
    mlp_bias=True,
    frontend="audio",
    dtype="float32",
    remat=False,
)
