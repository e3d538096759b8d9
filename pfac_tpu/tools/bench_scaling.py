"""Multi-device scaling harness.

Runs the sharded engine over N-device meshes (default: 1, 2, 4, ... up
to every addressable device) and reports throughput per device and
parallel efficiency against the single-device engine, one JSON line per
mesh size. The 1-device-mesh line measures shard_map overhead. One
process drives every device.

Reference analog: the multi-GPU chunk+halo verification loop in
PFAC/test/omp_PFAC.cpp:343-439 (which measured per-GPU chunks serially).

Run:  python -m pfac_tpu.tools.bench_scaling [--mb 64] [--mesh 1,2,4]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def median_s(dispatch, reps: int = 5) -> float:
    """Median seconds of dispatch() (ending in block_until_ready) after
    one warm-up call."""
    import jax

    jax.block_until_ready(dispatch())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(dispatch())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64, help="corpus MB (global)")
    ap.add_argument("--mesh", type=str, default="",
                    help="comma-separated mesh sizes (default: 1..ndev)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import jax

    from ..core.automaton import Automaton
    from ..backends import golden
    from ..dist.sharding import ShardedMatcher, make_data_mesh
    from ..runtime import compile_cache
    from ..runtime.handle import Matcher
    from .workloads import random_bytes, snort_like_patterns

    compile_cache.enable()
    ndev = len(jax.devices())
    sizes = ([int(x) for x in args.mesh.split(",") if x]
             if args.mesh else
             sorted({s for s in (1, 2, 4, 8, 16, 32, ndev) if s <= ndev}))

    rng = np.random.default_rng(args.seed)
    a = Automaton.from_patterns(snort_like_patterns())
    n = args.mb << 20
    data = random_bytes(rng, n)

    # parity gate on a slice before any timing
    s = bytes(data[: 1 << 18].tobytes())
    expected = golden.match_dense_batch(a, s)
    single = Matcher(automaton=a)._engine()
    assert np.array_equal(single.match(s), expected), \
        "single-device parity failed"

    dd = jax.device_put(data)
    t_single = median_s(lambda: single.match_device(dd))
    base_gbps = n / t_single / 1e9
    print(json.dumps({
        "harness": "scaling", "mesh": 0, "engine": type(single).__name__,
        "bytes": n, "GBps": base_gbps, "GBps_per_device": base_gbps,
        "efficiency": 1.0,
    }))

    for nd in sizes:
        sm = ShardedMatcher(a, mesh=make_data_mesh(nd))
        # shard-boundary parity on the slice (halo exchange correctness)
        assert np.array_equal(sm.match(s), expected), \
            f"sharded parity failed at mesh={nd}"
        shard_len = sm._shard_len(n)
        dg = sm._put(data, shard_len)
        fn = sm._match_fn(shard_len, n)
        t = median_s(lambda: fn(sm._tables, dg))
        gbps = n / t / 1e9
        print(json.dumps({
            "harness": "scaling", "mesh": nd, "engine": sm.engine,
            "bytes": n, "GBps": gbps, "GBps_per_device": gbps / nd,
            "efficiency": gbps / nd / base_gbps,
        }))


if __name__ == "__main__":
    main()
