"""dbrx-132b [moe] — 40L d_model=6144 48H (kv=8) d_ff=10752 vocab=100352.

16 experts, top-4, fine-grained [hf:databricks/dbrx-base]. Every layer MoE.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab=100352, rope_theta=500_000.0,
    n_experts=16, top_k=4,
    notes="16e top-4 MoE; GQA kv=8; block-dispatch uses the paper technique",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="dbrx-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_head=16, d_ff=96,
                          vocab=256, n_experts=4, top_k=2,
                          moe_capacity_factor=4.0)  # dropless at smoke scale
