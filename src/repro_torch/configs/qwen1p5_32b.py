"""qwen1.5-32b [dense] — 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064.

QKV bias per the Qwen1.5 family [hf:Qwen/Qwen1.5-0.5B scaled; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    notes="MHA (kv=40); SwiGLU; QKV bias",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="qwen1.5-32b-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256)
