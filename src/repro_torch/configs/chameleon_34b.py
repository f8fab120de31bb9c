"""chameleon-34b [vlm] — 48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536.

Early-fusion VLM: images arrive as VQ tokens in the shared 65536 vocab
[arXiv:2405.09818], so the backbone is a dense GQA decoder and the modality
frontend is the (stubbed) VQ tokenizer — ``input_specs`` provides token ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536, rope_theta=10_000.0,
    notes="early-fusion VLM; VQ image tokens share the text vocab (frontend stub)",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(name="chameleon-reduced", n_layers=2, d_model=64,
                          n_heads=8, n_kv_heads=2, d_head=8, d_ff=160, vocab=256)
