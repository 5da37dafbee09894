"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32 ⇒ MHA) d_ff=14336
vocab=32000 ssm_state=64; Mamba2 backbone + ONE shared attention+MLP block
applied every 6 layers (simplified from Zamba2's LoRA-specialized shared
blocks).  head_dim = 3584/32 = 112.  [arXiv:2411.15242; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, mlp_act="gelu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    shared_attn_every=6, train_microbatches=8, ssm_super=8,
    seq_shard_activations=False,
)
