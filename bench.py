"""Flagship benchmark: dense-table match throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, ...}

Baseline: the reference's headline number — 208.53 Gbps (26.07 GB/s) raw
match throughput on a GTX480 for Snort-scale patterns over 192 MB of
"pure" (random payload) packets (reference: PFAC/doc/PFAC_algorithm.pdf
Table 2; BASELINE.md). vs_baseline = ours / 26.07.

Workload mirrors the paper's setup statistics: ~2,000 patterns /
~42K pattern chars (Snort V2.8 scale), random-byte corpus, device-resident
input, dense (time-driven) table. The whole timed corpus is checked
against the golden oracle before any number is reported. Without a GPU
the script prints ``"ok": false`` and exits non-zero.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

CORPUS_MB = 128
REPEATS = 10
BASELINE_GBPS = 208.53 / 8.0  # 26.07 GB/s
METRIC = "dense_match_throughput_1chip"


def measure(corpus_mb: int = CORPUS_MB, repeats: int = REPEATS) -> dict:
    """Time Matcher.match_device on the flagship workload (median of
    `repeats` calls, each ending in block_until_ready)."""
    import jax

    from pfac_tpu import Automaton, Matcher
    from pfac_tpu.backends import golden
    from pfac_tpu.tools.workloads import random_bytes, snort_like_patterns

    dev = jax.devices()[0]
    patterns = snort_like_patterns()
    automaton = Automaton.from_patterns(patterns)

    # --- correctness gate: conformance corpus parity before timing
    conf = Matcher([b"AB", b"ABG", b"BEDE", b"ED"])
    assert conf.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0], (
        "conformance corpus parity failed"
    )

    n = corpus_mb << 20
    data = random_bytes(np.random.default_rng(0), n)
    data_dev = jax.device_put(data, dev)
    eng = Matcher(automaton=automaton)._engine()

    # full-corpus parity gate: the ENTIRE timed result (compile + warm-up
    # call) against the vectorized oracle
    out = np.asarray(eng.match_device(data_dev))
    expected = golden.match_dense_batch(automaton, data)
    assert np.array_equal(out[:n], expected), "full-corpus parity failed"
    n_matched = int((expected > 0).sum())
    del out, expected

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        eng.match_device(data_dev).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    gbps = n / dt / 1e9
    return {
        "metric": METRIC,
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / BASELINE_GBPS,
        "ok": True,
        "corpus_mb": corpus_mb,
        "num_patterns": len(patterns),
        "num_states": automaton.num_states,
        "matches": n_matched,
        "engine": type(eng).__name__,
        "time_s": dt,
        "times_ms": [t * 1e3 for t in times],
        "spread": (max(times) - min(times)) / dt,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def main() -> int:
    import jax

    from pfac_tpu.runtime import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"metric": METRIC, "ok": False,
                          "error": f"needs a GPU; JAX found {dev.platform}"}))
        return 1
    compile_cache.enable()
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
