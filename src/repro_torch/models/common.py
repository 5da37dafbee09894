"""Model configuration shared by all 10 architectures of the LM scaffold:
the port's own copy of the reference's ``ModelConfig`` (every field,
``reduced`` and the properties) and its analytic ``param_count``."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """One config covers every arch family in the pool (dense / moe / ssm /
    hybrid / vlm / audio-enc-dec); family-specific fields default off."""

    name: str = "model"
    family: str = "dense"            # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention flavor
    rope_theta: float = 10_000.0
    qk_norm: bool = False                      # qwen3
    attn_softcap: Optional[float] = None       # gemma2 (50.0)
    final_softcap: Optional[float] = None      # gemma2 (30.0)
    sliding_window: Optional[int] = None
    swa_pattern: str = "none"                  # none | all | alternating
    mrope_sections: Optional[tuple] = None     # qwen2-vl (t,h,w) rope split

    # mlp
    mlp_act: str = "silu"                      # silu => SwiGLU, gelu => GeGLU

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128

    # hybrid (zamba2): shared attention block applied every N ssm blocks
    shared_attn_every: int = 0

    # encoder-decoder (seamless)
    n_enc_layers: int = 0

    input_mode: str = "tokens"                 # tokens | embeds (stub frontend)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # training-time behavior
    remat: str = "full"                        # none | full | dots
    loss_chunk: int = 512                      # sequence-chunked xent
    train_microbatches: int = 1                # grad-accumulation splits
    ssm_super: int = 4                         # SSD chunks per checkpoint span
    # sequence parallelism for inter-layer activations (Korthikanti et al.
    # [arXiv:2205.05198]): the scan-carry stack (the dominant train-memory
    # term) shards over the model axis; attention gathers the sequence
    # internally anyway, so AR(out) ↔ AG(qkv)+RS(out) is comm-neutral.
    # Off for SSM/hybrid (the conv/scan would need halo exchanges).
    seq_shard_activations: bool = True
    zero1_compute_params: bool = False   # TP-only bf16 compute weights

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: SSM/hybrid state or all-layer SWA
        rolling window.  Alternating local/global (gemma2) keeps full-KV
        layers → not sub-quadratic (DESIGN.md §6)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_pattern == "all" and self.sliding_window is not None

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab_size=512, loss_chunk=64,
        )
        if self.n_kv_heads == self.n_heads:
            small["n_kv_heads"] = 4
        if self.n_experts:
            small.update(n_experts=4, top_k=min(2, self.top_k))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
        if self.shared_attn_every:
            small.update(n_layers=4, shared_attn_every=2)
        if self.n_enc_layers:
            small.update(n_enc_layers=2)
        if self.mrope_sections:
            small.update(mrope_sections=(8, 4, 4))
        small.update(overrides)
        return replace(self, **small)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6·N·D model-FLOPs in §Roofline)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
    mlp = 3 * D * F                       # gated (in, gate, out)
    per_layer = 0
    if cfg.family == "ssm":
        di, N, G, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
        per_layer = (D * (2 * di + 2 * G * N + Hs)     # in_proj (z,x,B,C,dt)
                     + (di + 2 * G * N) * cfg.ssm_conv  # conv
                     + Hs + Hs                          # A_log, D skip
                     + di * D + 2 * D)                  # out_proj + norms-ish
        total = cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        di, N, G, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
        ssm_l = (D * (2 * di + 2 * G * N + Hs) + (di + 2 * G * N) * cfg.ssm_conv
                 + 2 * Hs + di * D + 2 * D)
        total = cfg.n_layers * ssm_l + (attn + mlp + 2 * D)  # one shared block
    else:
        if cfg.n_experts:
            mlp = cfg.n_experts * 3 * D * F
        per_layer = attn + mlp + 2 * D
        if cfg.n_experts:
            per_layer += D * cfg.n_experts  # router
        total = cfg.n_layers * per_layer
        if cfg.is_enc_dec:
            # encoder layers (attn+mlp) + decoder cross-attn additions
            enc_l = attn + 3 * D * F + 2 * D
            total = cfg.n_enc_layers * enc_l + cfg.n_layers * (per_layer + attn + D)
    total += V * D * (1 if cfg.tie_embeddings else 2) + D
    return int(total)
