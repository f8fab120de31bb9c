"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000.

Mamba-2 backbone with a single weight-shared attention+MLP block applied
every ``hybrid_group`` Mamba layers, with per-site LoRA adapters
[arXiv:2411.15242]. ssm_state=64.

Simplifications recorded in DESIGN.md: the shared-block input is the
residual stream (no embedding concat); LoRA rank 128 on the shared QKV and
MLP-in projections.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14336, vocab=32000, rope_theta=10_000.0,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_group=6, lora_rank=128,
    notes="Mamba2 + shared attn blocks (13 sites) + per-site LoRA",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="zamba2-reduced", n_layers=7, d_model=64,
                          n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
                          vocab=256, ssm_state=8, ssm_head_dim=16,
                          hybrid_group=3, lora_rank=8)
