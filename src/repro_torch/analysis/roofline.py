"""Roofline terms of a dry-run cost vector against a card's peaks.

The reference (``repro.analysis.roofline``) computes, per chip,

    compute_s    = flops_per_device / peak_flops
    memory_s     = bytes_per_device / hbm_bw
    collective_s = collective_bytes_per_device / link_bw

and names the largest term the bottleneck. The port keeps that arithmetic,
the :class:`Roofline` record and its ``to_row()`` keys, and the HLO text
parser :func:`collective_bytes` (pure text functions, so the module's
contract stays the reference's; the port's one-card program has no HLO and
no collective, and passes ``""``). The hardware is a table of cards
(:data:`HARDWARE`) in place of the reference's single TPU row: a caller on
a card reads its row with :func:`hw_for`, a caller without one names the
row (``hw="NVIDIA H100 80GB HBM3"``) or passes its own mapping.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional, Union

import torch

__all__ = ["HARDWARE", "hw_for", "hw_row", "collective_bytes", "Roofline",
           "roofline_terms", "model_flops_estimate"]

# NVIDIA's data sheet for the SXM part at its 700 W power limit, dense
# rates without sparsity: bf16 on the tensor cores, HBM3, NVLink 4 per
# direction over all 18 links. A card set below 700 W runs slower under
# load; chip_smoke.py prints the measured card line (name, power limit)
# beside every share it computes against these.
HARDWARE: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "peak_flops": 989.4e12,    # bf16 FLOP/s
        "hbm_bw": 3.35e12,         # B/s
        "link_bw": 450e9,          # B/s each way
        "memory_bytes": 80e9,      # device memory, data-sheet GB
    },
}

HwLike = Union[None, str, Mapping[str, float]]


def hw_for(device="cuda") -> Dict[str, float]:
    """The :data:`HARDWARE` row of the card ``device`` names (its
    ``torch.cuda.get_device_name``), with its ``"name"``. Raises on the CPU
    or any device that is not a card, and on a card the table lacks: no
    other card's figures stand in for it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no card at {dev}: name a row of HARDWARE "
                         f"({sorted(HARDWARE)}) with hw=")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA card visible: name a row of HARDWARE "
                           f"({sorted(HARDWARE)}) with hw=")
    name = torch.cuda.get_device_name(dev)
    if name not in HARDWARE:
        raise KeyError(f"card {name!r} has no row in HARDWARE "
                       f"({sorted(HARDWARE)})")
    return {"name": name, **HARDWARE[name]}


def hw_row(hw: HwLike) -> Mapping[str, float]:
    """A row of :data:`HARDWARE` by name, a mapping as given, or (None)
    the row of the card this process runs on (:func:`hw_for`)."""
    if hw is None:
        return hw_for("cuda")
    if isinstance(hw, str):
        if hw not in HARDWARE:
            raise KeyError(f"{hw!r} has no row in HARDWARE "
                           f"({sorted(HARDWARE)})")
        return {"name": hw, **HARDWARE[hw]}
    return hw


# ---------------------------------------------------------------------------
# collective bytes from HLO text (the reference's parser, unchanged)
# ---------------------------------------------------------------------------
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s+(\(?[a-z0-9#,\[\]{}() ]+?\)?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

# bytes actually moved over links, as a multiple of the RESULT size
# (ring-algorithm estimates; reduce-scatter uses operand = result x group).
_XFER_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "all-to-all": 1.0,
                "collective-permute": 1.0}


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective-kind link bytes from optimized HLO text.

    Optimized HLO prints operands as bare names, so sizes are read from the
    RESULT shape (printed left of '='), scaled per kind: all-reduce moves
    ~2x its size (reduce+broadcast ring), reduce-scatter moves ~operand =
    result x group_size, the others ~1x. ``-done`` halves of async pairs are
    skipped so async collectives are counted once.
    """
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        result_seg, kind, startdone = m.group(1), m.group(2), m.group(3)
        if startdone == "-done":
            continue
        total = sum(_shape_bytes(dm.group(1), dm.group(2))
                    for dm in _SHAPE_RE.finditer(result_seg))
        if kind == "reduce-scatter":
            gm = _GROUPS_RE.search(line)
            group = int(gm.group(2)) if gm else 1
            total *= group
        else:
            total = int(total * _XFER_FACTOR[kind])
        out[kind] = out.get(kind, 0) + total
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device
    bytes_hbm: float             # per-device
    bytes_coll: float            # per-device
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None   # global 6*N*D
    useful_ratio: Optional[float] = None  # model_flops / (flops * chips)

    def to_row(self) -> Dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.bytes_hbm,
            "coll_bytes_per_dev": self.bytes_coll,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "coll_breakdown": self.coll_breakdown,
        }


def roofline_terms(cost: Dict, hlo_text: str, *, chips: int,
                   model_flops: Optional[float] = None,
                   hw: HwLike = None) -> Roofline:
    """The reference's terms for ``cost`` (``"flops"``, ``"bytes
    accessed"``) and the collectives of ``hlo_text`` against ``hw`` (see
    :func:`hw_row`; a mapping needs ``peak_flops``, ``hbm_bw`` and
    ``link_bw``)."""
    row = hw_row(hw)
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(hlo_text)
    cbytes = float(sum(coll.values()))
    compute_s = flops / row["peak_flops"]
    memory_s = nbytes / row["hbm_bw"]
    collective_s = cbytes / row["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / max(flops * chips, 1.0)
    return Roofline(flops, nbytes, cbytes, coll, compute_s, memory_s,
                    collective_s, bottleneck, model_flops, useful)


def model_flops_estimate(n_params_active: float, n_tokens: float,
                         kind: str = "train") -> float:
    """6*N*D for training (fwd+bwd), 2*N*D for inference forward."""
    c = 6.0 if kind == "train" else 2.0
    return c * n_params_active * n_tokens
