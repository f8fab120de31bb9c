"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only transformer backbone (same as wav2vec2) [arXiv:2106.07447].
The conv waveform frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings [B, T, 1280]; sinusoidal positions are
added in the embed stage. Output head: 504-way frame classification.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_head=80,
    d_ff=5120, vocab=504, rope_theta=None, causal=False,
    norm="layer", act="gelu", mlp_gated=False, frontend="stub_embed",
    notes="encoder-only; audio frontend stubbed as precomputed embeddings",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="hubert-reduced", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=64)
