"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280.

SSD (state-space duality) [arXiv:2405.21060]; d_inner = 2*d_model = 3072,
head_dim 64 (48 ssm heads), ssm_state=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280, rope_theta=None,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    notes="attention-free SSD; tied embeddings per mamba convention",
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="mamba2-reduced", n_layers=3, d_model=64,
                          vocab=256, ssm_state=16, ssm_head_dim=16)
