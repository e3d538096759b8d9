"""Regime benchmark matrix: one JSON line per corpus regime.

Complements bench.py's single headline metric with the reference's other
benchmark regimes (BASELINE.md): DEFCON-like mixed traffic, the
virus-dense worst case, the reduce path, a 100K-signature ruleset and
the Benchmark-I all-match / no-match corpora. Every regime runs through
`Matcher`; each time is the median of several `match_device` (or
`match_reduce_device`) calls ending in block_until_ready. Results go to
stdout only.

Run:  python tools_bench_matrix.py          (needs a GPU)
"""
import json
import sys
import time

import jax
import numpy as np

from pfac_tpu import Automaton, Matcher
from pfac_tpu.backends import golden
from pfac_tpu.tools import workloads


def median_s(dispatch, reps: int = 5) -> tuple[float, float]:
    """(median seconds, spread) of dispatch() after one warm-up call."""
    jax.block_until_ready(dispatch())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(dispatch())
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    return med, (max(ts) - min(ts)) / med


def run(scale: float = 1.0, emit=print) -> list[dict]:
    """Run every regime; sizes are multiplied by `scale` (1.0 = full)."""
    rng = np.random.default_rng(42)
    dev = jax.devices()[0]
    records = []

    def size(mb: int) -> int:
        return max(1 << 12, int((mb << 20) * scale))

    def record(regime, m, arr, check_with=golden.match_dense_batch,
               reduce=False, extra=None):
        # parity on a slice, then device timing
        s = arr[: 1 << 20]
        assert np.array_equal(m.match(s), check_with(m.automaton, s)), \
            f"{regime}: parity failed"
        dd = jax.device_put(arr)
        fn = m.match_reduce_device if reduce else m.match_device
        t, spread = median_s(lambda: fn(dd))
        rec = {"regime": regime, "bytes": int(arr.shape[0]), "ms": t * 1e3,
               "GBps": arr.shape[0] / t / 1e9, "spread": spread,
               "engine": type(m._engine()).__name__,
               "platform": dev.platform, "device_kind": dev.device_kind}
        rec.update(extra or {})
        records.append(rec)
        emit(json.dumps(rec))

    pats = workloads.snort_like_patterns()
    m = Matcher(automaton=Automaton.from_patterns(pats))
    record("dense_random", m, workloads.random_bytes(rng, size(128)))
    record("defcon_like_1.5pct", m,
           workloads.planted_text(rng, pats, size(128)),
           extra={"reference_GBps": 15.4})
    record("virus_dense_worst", m, workloads.virus_dense(rng, pats, size(8)),
           extra={"reference_worst_GBps": 1.12})

    # compaction at ~3% match density: one single-byte pattern over a
    # corpus where that byte has probability 0.03
    n = size(64)
    arr = np.where(rng.integers(0, 100, size=n) < 3, 7, 8).astype(np.uint8)
    record("reduce_device_3pct", Matcher([b"\x07"]), arr, reduce=True,
           extra={"matches": int((arr == 7).sum())})

    # big-ruleset tier: 100K ClamAV-scale binary signatures (lengths
    # 8-200) over DEFCON-like text with ~0.2% planted content. The dense
    # table is states x 257 x 4 B (~6 GB); the edge-list oracle checks it.
    kbig = max(1000, int(100_000 * scale))
    lens = np.clip(rng.gamma(3.0, 18.0, size=kbig) + 8, 8, 200).astype(int)
    raw = rng.integers(0, 256, size=int(lens.sum()), dtype=np.uint8)
    ends = np.cumsum(lens)
    bpats = list(dict.fromkeys(raw[e - ln:e].tobytes()
                               for e, ln in zip(ends, lens)))
    big = Matcher(automaton=Automaton.from_patterns(bpats))
    record("big_ruleset_100k_defcon", big,
           workloads.planted_text(rng, bpats, size(64), share=0.002),
           check_with=golden.match_edges_batch,
           extra={"patterns": len(bpats),
                  "states": big.automaton.num_states})

    # Benchmark-I analogs (reference: PFAC/doc/PFAC_hash_draft.pdf
    # Table 4): one short pattern over all-'a' input (every position
    # matches) and all-'b' input (no match)
    a4 = Matcher([b"aaaa"])
    n = size(100)
    record("benchmark1_all_match", a4, np.full(n, ord("a"), np.uint8),
           extra={"reference_GBps": 12.9})
    record("benchmark1_no_match", a4, np.full(n, ord("b"), np.uint8),
           extra={"reference_GBps": 24.5})
    return records


def main() -> int:
    from pfac_tpu.runtime import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    compile_cache.enable()
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
