"""Rulesets and corpora shared by the benchmark, the smoke run and tools.

The flagship ruleset follows the statistics the PFAC paper reports for
Snort V2.8 (about 2,000 patterns, lengths 1-243, BASELINE.md). Every
generator takes a NumPy ``Generator`` so runs are reproducible from a
seed.
"""
from __future__ import annotations

import numpy as np


def snort_like_patterns(seed: int = 42, k: int = 2000) -> list[bytes]:
    """Synthetic rule set with Snort-paper statistics: k patterns, lengths
    1..243 skewed short (avg ~21), mixed text/binary bytes."""
    rng = np.random.default_rng(seed)
    pats = []
    for _ in range(k):
        ln = int(np.clip(rng.gamma(shape=2.2, scale=9.0) + 1, 1, 243))
        if rng.random() < 0.7:  # text-ish
            p = rng.integers(32, 127, size=ln, dtype=np.int64)
        else:  # binary
            p = rng.integers(0, 256, size=ln, dtype=np.int64)
        pats.append(bytes(p.astype(np.uint8)))
    # dedupe while keeping order (duplicate rules are rare in real sets)
    seen, out = set(), []
    for p in pats:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def random_bytes(rng: np.random.Generator, n: int) -> np.ndarray:
    """Uniform random payload: the paper's "pure" packets."""
    return rng.integers(0, 256, size=n, dtype=np.uint8)


def planted_text(rng: np.random.Generator, patterns: list[bytes], n: int,
                 share: float = 0.015) -> np.ndarray:
    """DEFCON-like traffic: printable text with `share` of its bytes
    overwritten by whole patterns at random offsets."""
    buf = rng.integers(32, 127, size=n, dtype=np.uint8)
    budget, placed = int(n * share), 0
    while placed < budget:
        p = patterns[int(rng.integers(0, len(patterns)))]
        off = int(rng.integers(0, n - len(p)))
        buf[off:off + len(p)] = np.frombuffer(p, np.uint8)
        placed += len(p)
    return buf


def virus_dense(rng: np.random.Generator, patterns: list[bytes],
                n: int) -> np.ndarray:
    """Worst case: the corpus is patterns laid end to end, so walks are
    deep everywhere."""
    chunks, size = [], 0
    while size < n:
        p = patterns[int(rng.integers(0, len(patterns)))]
        chunks.append(p)
        size += len(p)
    return np.frombuffer(b"".join(chunks)[:n], dtype=np.uint8).copy()
