"""Graph data pipeline: the paper's 18 benchmark graphs as synthetic analogues.

Table I of the paper lists node/edge counts for 18 public graphs. Offline, we
generate power-law (preferential-attachment-style) graphs matched to those
counts — the degree distribution is the property that drives every effect the
paper measures (workload imbalance, locality). The three largest graphs
(PRODUCTS, Reddit, PPA) are generated at reduced edge counts on this host
(noted in ``scale``), keeping node counts and density character.

Node features and labels are synthetic (seeded), so every experiment is
reproducible bit-for-bit from (name, seed).
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from ..core.graph import CSRGraph, csr_from_edges

# name -> (n_nodes, n_edges, scale) ; scale<1 => edges reduced by that factor
BENCHMARK_GRAPHS: Dict[str, Tuple[int, int, float]] = {
    "am":              (881_680, 5_668_682, 1.0),
    "amazon0601":      (403_394, 5_478_357, 1.0),
    "Artist":          (50_515, 1_638_396, 1.0),
    "Arxiv":           (169_343, 1_166_243, 1.0),
    "Citation":        (2_927_963, 30_387_995, 0.25),
    "Collab":          (235_868, 2_358_104, 1.0),
    "com-amazon":      (334_863, 1_851_744, 1.0),
    "OVCAR-8H":        (1_889_542, 3_946_402, 1.0),
    "PRODUCTS":        (2_449_029, 123_718_280, 0.05),
    "Pubmed":          (19_717, 99_203, 1.0),
    "PPA":             (576_289, 42_463_862, 0.15),
    "Reddit":          (232_965, 114_615_891, 0.05),
    "SW-620H":         (1_888_584, 3_944_206, 1.0),
    "TWITTER-Partial": (580_768, 1_435_116, 1.0),
    "wikikg2":         (2_500_604, 16_109_182, 0.4),
    "Yelp":            (716_847, 13_954_819, 0.5),
    "Yeast":           (1_710_902, 3_636_546, 1.0),
    "youtube":         (1_138_499, 5_980_886, 1.0),
}


def make_power_law_graph(n: int, m_edges: int, seed: int = 0,
                         alpha: float = 1.8) -> CSRGraph:
    """Power-law multigraph: out-degrees ~ zipf(alpha) scaled to m_edges,
    endpoints preferential (zipf-ranked), O(E) construction."""
    rng = np.random.default_rng(seed)
    # zipf out-degrees, rescaled to hit the edge budget
    raw = rng.zipf(alpha, n).astype(np.float64)
    deg = np.maximum(1, np.round(raw * (m_edges / raw.sum()))).astype(np.int64)
    # exact edge budget
    diff = int(deg.sum() - m_edges)
    if diff > 0:
        idx = rng.choice(n, size=diff, replace=True, p=deg / deg.sum())
        np.subtract.at(deg, idx, 1)
        deg = np.maximum(deg, 0)
    elif diff < 0:
        idx = rng.integers(0, n, size=-diff)
        np.add.at(deg, idx, 1)
    E = int(deg.sum())
    src = np.repeat(np.arange(n), deg)
    # preferential endpoints: sample by rank-skewed distribution
    u = rng.random(E)
    dst = np.minimum((n * u ** 2.0).astype(np.int64), n - 1)  # quadratic skew
    dst = rng.permutation(n)[dst]  # decorrelate hub ids from small indices
    return csr_from_edges(src, dst, n)


def make_benchmark_graph(name: str, seed: int = 0) -> Tuple[CSRGraph, float]:
    n, e, scale = BENCHMARK_GRAPHS[name]
    g = make_power_law_graph(n, int(e * scale), seed=seed)
    return g, scale


def node_features(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.normal(size=(n, d)).astype(np.float32)


def node_labels(n: int, n_classes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 2)
    return rng.integers(0, n_classes, size=n).astype(np.int32)


def seed_splits(n: int, fractions: Sequence[float],
                seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Disjoint seed-node masks (train/val/test style) over ``n`` nodes.

    ``fractions`` are consumed in order off one seeded permutation, so the
    split is deterministic in (n, fractions, seed) and masks never overlap.
    ``sum(fractions)`` may be < 1 (the remainder is unassigned) but not > 1.
    Returns one bool[n] mask per fraction.
    """
    total = float(sum(fractions))
    if total > 1.0 + 1e-9:
        raise ValueError(f"fractions sum to {total} > 1")
    order = np.random.default_rng(seed).permutation(n)
    masks = []
    lo = 0
    for f in fractions:
        hi = lo + int(round(f * n))
        m = np.zeros(n, dtype=bool)
        m[order[lo:hi]] = True
        masks.append(m)
        lo = hi
    return tuple(masks)


def seed_batches(seeds: np.ndarray, batch_size: int, *, seed: int = 0,
                 epochs: int = 1,
                 shuffle: bool = True) -> Iterator[np.ndarray]:
    """Deterministic seed-node batch iterator for sampled inference/training.

    ``seeds`` is a node-id array or a bool mask (converted via flatnonzero).
    Each epoch reshuffles with rng([seed, epoch]), so the full batch
    sequence is reproducible from (seeds, batch_size, seed) alone. The last
    short batch of an epoch is yielded, never dropped.
    """
    ids = np.asarray(seeds)
    if ids.dtype == bool:
        ids = np.flatnonzero(ids)
    ids = ids.astype(np.int64)
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    for epoch in range(epochs):
        order = (np.random.default_rng([seed, epoch]).permutation(len(ids))
                 if shuffle else np.arange(len(ids)))
        for lo in range(0, len(ids), batch_size):
            yield ids[order[lo:lo + batch_size]]
