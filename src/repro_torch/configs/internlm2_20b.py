"""internlm2-20b [dense] — 48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92544.

GQA 6:1 [arXiv:2403.17297; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=92544, rope_theta=1_000_000.0,
    notes="GQA kv=8; SwiGLU",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="internlm2-reduced", n_layers=2, d_model=64,
                          n_heads=8, n_kv_heads=2, d_head=8, d_ff=128, vocab=256)
