"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm.  [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, qk_norm=True, mlp_act="silu",
    rope_theta=1_000_000.0,
)
