"""Command-line tools: match + profile.

Equivalent of the reference's `profiling.cpp` CLI benchmark
(reference: PFAC/test/profiling.cpp:56-149,296-360) reporting GB/s per
device, device memory of the tables, and match counts.

Usage:
  python -m pfac_tpu.tools.cli match  -P patterns.txt -I corpus.bin [options]
  python -m pfac_tpu.tools.cli profile -P patterns.txt -I corpus.bin [options]

Options mirror the reference flags where they make sense:
  -P <file>   pattern file          (reference: -P)
  -I <file>   input file            (reference: -I)
  --space     space-driven (hashed) table   (reference: -S)
  --platform  device|cpu|cpu_parallel        (reference: -TH/-TD/CPU paths)
  --tile N    start positions per tile
  --iters N   timed iterations (profile)
  --sharded   use every visible device via the data mesh
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_matcher(args):
    from ..runtime.handle import Matcher

    return Matcher(
        pattern_file=args.patterns,
        perf_mode="hash" if args.space else "dense",
        platform=args.platform,
        tile=args.tile,
    )


def cmd_match(args) -> int:
    if args.sharded:
        from ..core.automaton import Automaton
        from ..dist.sharding import ShardedMatcher

        with open(args.input, "rb") as f:
            data = f.read()
        a = Automaton.from_pattern_file(args.patterns)
        m = ShardedMatcher(a, perf_mode="hash" if args.space else "dense")
        ids, pos, n = m.match_reduce(data)
    elif args.stream:
        # chunked scan: bounded memory for arbitrarily large inputs
        m = _build_matcher(args)
        sm = m.stream(min_batch=args.stream_chunk)
        ids_parts, pos_parts = [], []

        def collect(start, out):
            hit = np.flatnonzero(out > 0)
            if hit.size:
                ids_parts.append(out[hit])
                pos_parts.append((hit + start).astype(np.int64))

        with open(args.input, "rb") as f:
            while True:
                chunk = f.read(args.stream_chunk)
                if not chunk:
                    break
                collect(*sm.feed(chunk))
        collect(*sm.finish())
        ids = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int32)
        pos = np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
        n = int(ids.shape[0])
    else:
        with open(args.input, "rb") as f:
            data = f.read()
        m = _build_matcher(args)
        ids, pos, n = m.match_reduce(data)
    print(f"num_matched = {n}")
    limit = n if args.all else min(n, args.head)
    for i in range(limit):
        print(f"At position {int(pos[i]):4d}, match pattern {int(ids[i])}")
    if limit < n:
        print(f"... ({n - limit} more; --all to print)")
    return 0


def cmd_profile(args) -> int:
    import jax

    from ..runtime import compile_cache

    compile_cache.enable()
    with open(args.input, "rb") as f:
        data = f.read()
    n = len(data)
    m = _build_matcher(args)
    eng = m._engine()

    data_dev = jax.device_put(np.frombuffer(data, dtype=np.uint8))
    out = eng.match_device(data_dev).block_until_ready()   # compile + warm

    if args.trace:
        # one traced iteration for the profiler UI (xprof/tensorboard)
        with jax.profiler.trace(args.trace):
            eng.match_device(data_dev).block_until_ready()

    times = []
    for _ in range(max(1, args.iters)):
        t0 = time.perf_counter()
        eng.match_device(data_dev).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    n_matched = int(np.asarray((out > 0).sum()))

    report = {
        "input_bytes": n,
        "elapsed_ms": round(dt * 1e3, 3),
        "throughput_GBps": round(n / dt / 1e9, 3),
        "throughput_Gbps": round(n * 8 / dt / 1e9, 2),
        "num_matched": n_matched,
        "perf_mode": "space" if args.space else "time",
        "num_states": m.automaton.num_states,
        "engine": type(eng).__name__,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(report, indent=2))
    sys.stdout.write(m.memory_usage())
    if args.histogram:
        hist = m.automaton.match_histogram(np.asarray(out)[:n])
        for pid, c in sorted(hist.items(), key=lambda kv: -kv[1])[:20]:
            print(f"pattern {pid:6d}: {c} matches")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pfac-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("match", "profile"):
        sp = sub.add_parser(name)
        sp.add_argument("-P", "--patterns", required=True)
        sp.add_argument("-I", "--input", required=True)
        sp.add_argument("-S", "--space", action="store_true")
        sp.add_argument("--platform", default="device",
                        choices=["device", "cpu", "cpu_parallel"])
        sp.add_argument("--tile", type=int, default=None)
        if name == "match":
            sp.add_argument("--head", type=int, default=20)
            sp.add_argument("--all", action="store_true")
            sp.add_argument("--sharded", action="store_true")
            sp.add_argument("--stream", action="store_true",
                            help="chunked scan via StreamMatcher (bounded memory)")
            sp.add_argument("--stream-chunk", type=int, default=16 << 20)
        else:
            sp.add_argument("--iters", type=int, default=5)
            sp.add_argument("--trace", default=None, metavar="DIR",
                            help="write a jax.profiler trace of one iteration")
            sp.add_argument("--histogram", action="store_true",
                            help="print per-pattern match counts")
    args = p.parse_args(argv)
    return cmd_match(args) if args.cmd == "match" else cmd_profile(args)


if __name__ == "__main__":
    raise SystemExit(main())
