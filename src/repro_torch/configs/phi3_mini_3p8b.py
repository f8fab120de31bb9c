"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU + (degenerate, kv=heads) GQA [arXiv:2404.14219].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, rope_theta=10_000.0,
    notes="RoPE SwiGLU; MHA",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="phi3-mini-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_head=16, d_ff=160, vocab=256)
