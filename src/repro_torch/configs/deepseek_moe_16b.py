"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400.

2 shared + 64 routed experts, top-6, fine-grained [arXiv:2401.06066; hf].
First layer uses a dense FFN (d_ff=10944) per the published config.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=102400, rope_theta=10_000.0,
    n_experts=64, top_k=6, n_shared_experts=2,
    first_dense_layers=1, first_dense_ff=10944,
    notes="fine-grained MoE: 2 shared + 64 routed top-6; first layer dense",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="deepseek-moe-reduced", n_layers=3, d_model=64,
                          n_heads=4, n_kv_heads=4, d_head=16, d_ff=48,
                          vocab=256, n_experts=8, top_k=2, n_shared_experts=1,
                          first_dense_layers=1, first_dense_ff=128,
                          moe_capacity_factor=4.0)  # dropless at smoke scale
