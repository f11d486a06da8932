"""Unified model configuration covering all assigned architecture families.
Counterpart of `repro.models.config`, field for field: the same dataclasses,
defaults, derived properties and parameter counts.

One ``ModelConfig`` describes dense/GQA/MLA transformers, MoE, Mamba2 (SSD),
hybrid attention+SSM interleaves, encoder-decoder, and stub-fronted
multimodal backbones.  The paper's technique is exposed as ``quant``:

  * ``none``           — standard dense weights.
  * ``ternary``        — QAT fake-quant: every projection goes through the
                          TWN straight-through estimator (core.ternary).
  * ``ternary_packed`` — inference: weights stored 2-bit packed (uint8) and
                          expanded on the fly; weight HBM traffic drops 8x
                          vs bf16 — the CUTIE data-movement insight.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"           # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    # MLA (deepseek)
    q_lora_rank: int = 0             # 0 = full-rank q projection
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MLP ---------------------------------------------------------------
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    mlp_bias: bool = False

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1        # MoE FFN every k-th layer (jamba: 2)
    first_dense_layers: int = 0      # deepseek: first k layers use dense FFN
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_layer_period: int = 0       # jamba: 1 attention layer per period
    attn_layer_offset: int = 4

    # --- encoder-decoder ----------------------------------------------------
    n_enc_layers: int = 0
    enc_seq_len: int = 0             # stub frontend sequence length

    # --- multimodal stub frontend --------------------------------------------
    frontend: str = "none"           # none | vision | audio
    frontend_seq: int = 0            # patches / frames prepended to the text

    # --- norms / embeddings ---------------------------------------------------
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    logit_softcap: float = 0.0

    # --- the paper's technique -------------------------------------------------
    quant: str = "none"              # none | ternary | ternary_packed
    act_quant: str = "none"          # none | ternary
    use_tcn_mapping: bool = False    # run ssm conv1d through the §4 2-D mapping

    # --- serving optimizations (hillclimb variants) ------------------------------
    mla_absorbed: bool = False       # W_uk/W_uv-absorbed MLA decode (latent-space
                                     # scores; no per-step K/V re-expansion)

    # --- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1   # dry-run probes unroll scans so cost_analysis
                           # counts every layer (while bodies count once)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ----- derived ---------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_layer_period == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_layer_period > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM or mostly-SSM hybrid)."""
        return self.ssm_state > 0

    def n_params(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim

        def attn_params() -> int:
            if self.attn_type == "mla":
                q = (
                    d * self.q_lora_rank
                    + self.q_lora_rank * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                    if self.q_lora_rank
                    else d * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                )
                kv_p = d * (self.kv_lora_rank + self.qk_rope_head_dim)
                kv_p += self.kv_lora_rank * h * (self.qk_nope_head_dim + self.v_head_dim)
                o = h * self.v_head_dim * d
                return q + kv_p + o
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def dense_ffn() -> int:
            mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            return (mult + 1) * d * f

        def moe_ffn() -> int:
            mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
            routed = self.n_experts * (mult + 1) * d * self.moe_d_ff
            shared = self.n_shared_experts * (mult + 1) * d * self.moe_d_ff
            router = d * self.n_experts
            return routed + shared + router

        def ssm_params() -> int:
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_p = d * (2 * di + 2 * ds + nh)
            conv = (di + 2 * ds) * self.ssm_conv
            return in_p + conv + 3 * nh + di * d  # A_log, D, dt_bias, out

        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d

        n_moe_layers = 0
        n_dense_ffn = 0
        n_attn = 0
        n_ssm = 0
        for i in range(self.n_layers):
            is_attn = (
                self.ssm_state == 0
                or (self.attn_layer_period and i % self.attn_layer_period == self.attn_layer_offset)
            )
            n_attn += int(is_attn)
            n_ssm += int(not is_attn)
            if (
                self.is_moe
                and i >= self.first_dense_layers
                and i % self.moe_layer_period
                == (self.moe_layer_period - 1 if self.moe_layer_period > 1 else 0)
            ):
                n_moe_layers += 1
            else:
                n_dense_ffn += 1
        if self.is_ssm:
            # pure SSM: no interleaved FFN stack (mamba2 has none)
            n_dense_ffn = 0
            n_moe_layers = 0
        total += n_attn * attn_params() + n_ssm * ssm_params()
        total += n_moe_layers * moe_ffn() + n_dense_ffn * dense_ffn()
        if self.is_encdec:
            # encoder layers: self-attn + ffn; decoder adds cross-attn (already
            # counted in n_layers above as self-attn + ffn; add cross-attn)
            total += self.n_enc_layers * (attn_params() + dense_ffn())
            total += self.n_layers * attn_params()  # cross-attention blocks
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        mult = 2 if self.mlp_type in ("swiglu", "geglu") else 1
        per_expert = (mult + 1) * self.d_model * self.moe_d_ff
        inactive = (self.n_experts - self.experts_per_tok) * per_expert
        n_moe_layers = sum(
            1
            for i in range(self.n_layers)
            if i >= self.first_dense_layers
            and i % self.moe_layer_period
            == (self.moe_layer_period - 1 if self.moe_layer_period > 1 else 0)
        )
        return self.n_params() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
