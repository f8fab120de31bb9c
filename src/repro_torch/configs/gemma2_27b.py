"""gemma2-27b [dense] — 46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000.

Local (sliding-window 4096) / global alternating attention, attn-logit
softcap 50, final-logit softcap 30, GeGLU, pre+post block norms, tied
embeddings, query scale (d_model/n_heads)^-1/2 [arXiv:2408.00118; hf].
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=36864, vocab=256000, rope_theta=10_000.0,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    local_global_period=2, attn_scale=(4608 / 32) ** -0.5,
    tie_embeddings=True, post_block_norm=True, act="gelu_tanh",
    notes="local+global alternating; logit softcaps; GeGLU",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="gemma2-reduced", n_layers=4, d_model=64,
                          n_heads=4, n_kv_heads=2, d_head=16, d_ff=192,
                          vocab=256, sliding_window=32,
                          attn_scale=(64 / 4) ** -0.5)
