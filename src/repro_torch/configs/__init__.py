"""Config registry: one module per assigned architecture (+ the paper's GCN).

``get_config(name)`` returns the full published config; ``get_reduced(name)``
the same-family smoke-test config (small dims, CPU-runnable).
"""
from __future__ import annotations

from .base import ArchConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME, shape_skips

ARCH_IDS = [
    "qwen1.5-32b",
    "phi3-mini-3.8b",
    "gemma2-27b",
    "internlm2-20b",
    "zamba2-7b",
    "hubert-xlarge",
    "dbrx-132b",
    "deepseek-moe-16b",
    "chameleon-34b",
    "mamba2-780m",
]

_MODULES = {
    "qwen1.5-32b": "qwen1p5_32b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma2-27b": "gemma2_27b",
    "internlm2-20b": "internlm2_20b",
    "zamba2-7b": "zamba2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "dbrx-132b": "dbrx_132b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-780m": "mamba2_780m",
}


def get_config(name: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.reduced()
