"""On-device randomized differential fuzz: compiled engines vs golden.

The pytest suite runs on a CPU mesh (the walk kernel in interpret mode);
this tool drives the COMPILED paths on the attached accelerator across
randomized rule sets and corpora — the only way to catch lowering
divergences.

Usage:  python -m pfac_tpu.tools.device_fuzz [--cases N] [--seed S]
Exits nonzero on the first mismatch, printing a reproducer.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _random_case(rng: np.random.Generator, heavy: bool = False,
                 wide: bool = False, allmatch: bool = False):
    if allmatch:
        # nearly every position walks deep, so every lane of whole kernel
        # blocks stays alive — compiled, incl. block-boundary straddles
        ch = int(rng.integers(97, 123))
        deep = int(rng.integers(5, 60))
        pats = [bytes([ch]) * 4, bytes([ch]) * deep,
                bytes([ch, ch, 123, 124])]
        n = int(rng.integers(1_500_000, 2_500_000))
        data = bytearray(bytes([ch]) * n)
        for _ in range(30):                    # breaks + near-end edges
            off = int(rng.integers(0, n))
            data[off] = int(rng.integers(0, 97))
        return pats, bytes(data)
    alpha = int(rng.integers(2, 257))
    k = int(rng.integers(1, 200))
    pats, seen = [], set()
    for _ in range(k):
        # heavy cases use the Snort length range (1-243): deep walker
        # steps run COMPILED here, not just in interpret tests
        ln = (int(np.clip(rng.gamma(2.2, 9.0) + 4, 4, 243)) if heavy
              else int(np.clip(rng.gamma(1.8, 4.0) + 1, 1, 64)))
        p = bytes(rng.integers(0, alpha, size=ln).astype(np.uint8))
        if p not in seen:
            seen.add(p)
            pats.append(p)
    if wide:
        # > 32767 pattern IDs: ids past int16 on the compiled path
        keys = rng.choice(1 << 16, size=33000, replace=False)
        wpats = [bytes([kk >> 8, kk & 0xFF]) for kk in keys]
        pats = wpats + [p for p in pats if len(p) >= 4][:50]
        n = int(rng.integers(100_000, 400_000))
        data = bytearray(rng.integers(0, 256, size=n)
                         .astype(np.uint8).tobytes())
        for _ in range(40):
            p = pats[int(rng.integers(0, len(pats)))]
            off = int(rng.integers(0, n - len(p) + 1))
            data[off:off + len(p)] = p
        return pats, bytes(data)
    if heavy:
        # virus-dense: the corpus is mostly pattern content, so walks
        # are deep at most positions
        n = int(rng.integers(1_500_000, 3_000_000))
        chunks, sz = [], 0
        while sz < n:
            p = pats[int(rng.integers(0, len(pats)))]
            chunks.append(p)
            sz += len(p)
        return pats, b"".join(chunks)[:n]
    n = int(rng.integers(1, 400_000))
    data = bytearray(rng.integers(0, alpha, size=n).astype(np.uint8).tobytes())
    # plant pattern occurrences, including at the very end
    for _ in range(min(20, n)):
        p = pats[int(rng.integers(0, len(pats)))]
        if len(p) <= n:
            off = int(rng.integers(0, n - len(p) + 1))
            data[off:off + len(p)] = p
    p = pats[0]
    if len(p) <= n:
        data[n - len(p):] = p
    return pats, bytes(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="also fuzz the sharded path on the local mesh")
    ap.add_argument("--heavy", action="store_true",
                    help="ALL cases virus-dense (default: every 5th case)")
    args = ap.parse_args(argv)

    import jax

    from ..runtime import compile_cache

    compile_cache.enable()

    from ..core.automaton import Automaton
    from ..backends import golden
    from ..runtime.handle import Matcher

    print(f"device: {jax.devices()[0]}")
    rng = np.random.default_rng(args.seed)
    for case in range(args.cases):
        # every 5th case is virus-dense; every 7th is a wide-ID case;
        # every 9th is all-match — all run COMPILED
        heavy = args.heavy or case % 5 == 4
        wide = (not heavy) and case % 7 == 3
        allmatch = (not heavy) and (not wide) and case % 9 == 5
        pats, data = _random_case(rng, heavy=heavy, wide=wide,
                                  allmatch=allmatch)
        a = Automaton.from_patterns(pats)
        m = Matcher(automaton=a)
        got = m.match(data)
        exp = golden.match_dense_batch(a, data)
        if not np.array_equal(got, exp):
            bad = np.nonzero(got != exp)[0][:5]
            print(f"MISMATCH case={case} seed={args.seed} "
                  f"k={len(pats)} n={len(data)} at {bad.tolist()}")
            for b in bad:
                print(f"  pos {b}: got {got[b]} expected {exp[b]}")
            return 1
        ids, pos, cnt = m.match_reduce(data)
        gi, gp, gc = golden.reduce_result(exp)
        if not (cnt == gc and np.array_equal(pos[:cnt], gp)
                and np.array_equal(ids[:cnt], gi)):
            print(f"REDUCE MISMATCH case={case} seed={args.seed}")
            return 1
        if not heavy and not wide and len(data) < 500_000 and case % 4 == 2:
            # DEVICE-side reduce on both engines (the platform's engine
            # and the XLA walker): keep the compiled reduce covered
            from ..backends.xla import XlaMatcher
            d_dev = jax.device_put(np.frombuffer(data, np.uint8))
            for eng in (m._engine(), XlaMatcher(a, perf_mode="dense")):
                rd = eng.match_reduce_device(d_dev)
                di, dp, dc = (np.asarray(x) for x in rd)
                dc = int(dc)
                if not (dc == gc and np.array_equal(dp[:dc], gp)
                        and np.array_equal(di[:dc], gi)):
                    print(f"REDUCE-DEVICE MISMATCH case={case} "
                          f"engine={type(eng).__name__} seed={args.seed} "
                          f"count={dc} expected={gc}")
                    return 1
        if args.sharded:
            from ..dist.sharding import ShardedMatcher
            sm = ShardedMatcher(a)
            got2 = sm.match(data)
            if not np.array_equal(got2, exp):
                print(f"SHARDED MISMATCH case={case} seed={args.seed}")
                return 1
        nm = int((exp > 0).sum())
        kind = " heavy" if heavy else " wide" if wide else ""
        print(f"case {case:3d}: ok{kind}  "
              f"engine={type(m._engine()).__name__} "
              f"k={len(pats)} n={len(data)} matches={nm}", flush=True)
    print("all cases passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
