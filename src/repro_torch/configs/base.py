"""Architecture + run configuration dataclasses.

Every assigned architecture gets one file in this package defining
``CONFIG: ArchConfig`` with the exact published dimensions, plus a
``reduced()`` helper producing the same-family smoke-test config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # attention
    qkv_bias: bool = False
    rope_theta: Optional[float] = 10_000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0     # 2 => alternate local/global (gemma-2)
    attn_scale: Optional[float] = None
    causal: bool = True
    tie_embeddings: bool = False
    norm: str = "rms"                # rms | layer
    post_block_norm: bool = False
    act: str = "silu"
    mlp_gated: bool = True
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    first_dense_ff: int = 0
    moe_capacity_factor: float = 1.25
    # ssm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_k: int = 4
    # hybrid (zamba-2): shared attn+mlp block every `hybrid_group` mamba layers
    hybrid_group: int = 0
    lora_rank: int = 0
    # modality frontend: token | stub_embed (precomputed frame/patch embeds)
    frontend: str = "token"
    notes: str = ""

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (kind, seq_len, global_batch)."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_skips(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip-reason string, or None if the (arch, shape) cell runs.

    Recorded per the assignment spec and DESIGN.md §5.
    """
    if cfg.family == "encoder" and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "long_500k requires sub-quadratic attention (pure full-attention arch)"
    return None
