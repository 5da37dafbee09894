"""mamba2-2.7b [ssm] — 64L d_model=2560 attention-free vocab=50280;
SSD (state-space duality) d_state=128, headdim=64, expand=2 → 80 heads.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    tie_embeddings=True, train_microbatches=8, ssm_super=8,
    seq_shard_activations=False,
)
