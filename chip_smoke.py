"""Smoke run of the matcher on an NVIDIA GPU: the quickest proof that the
system starts on the card and gives exact results at deployment size.

Usage:
  python chip_smoke.py            # one card, every single-card phase
  python chip_smoke.py --multi    # four cards: the sharded phase only

Everything runs in this one process (a JAX process reserves most of the
card). Each phase prints one line with its result and times. The line
before the last is the card's name and power limit from nvidia-smi; the
last line is one JSON object, ``{"ok": true, "device": {...}}`` only if
every phase passed. Without a GPU the script exits non-zero and prints
no result.

Phases (single card):
  1 device      platform, kind and count as JAX reports them
  2 readme      the reference's README example, dense and hash, through
                Matcher, match_reduce and the PFAC_* C API flow
  3 flagship    Snort-scale ruleset (~2,000 patterns) over 128 MB of
                random bytes and of DEFCON-like text with 1.5% planted
                patterns: match_device, match, match_reduce and
                match_reduce_device in both modes, exact against the
                golden oracle over the whole corpus
  4 kernel_ab   the GPU walk kernel against xla.walk_tiles on the same
                device input: identical results, both times
  5 edges       StreamMatcher in uneven chunks against the whole-buffer
                result; an 8 MB virus-dense and a 64 MB all-match corpus
                against the golden oracle
  6 sharded     ShardedMatcher on a one-card mesh equals Matcher
With --multi: 512 MB of the flagship text over a 4-card "data" mesh,
checked against single-card Matcher, golden slices at every shard
boundary, a device fingerprint, match_count and match_reduce.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

MB = 1 << 20
README_PATTERNS = [b"AB", b"ABG", b"BEDE", b"ED"]
README_INPUT = b"ABEDEDABG"
README_IDS = [1, 3, 4, 0, 4, 0, 2, 0, 0]
MODES = ("dense", "hash")


def _ms(t0: float) -> float:
    return round((time.perf_counter() - t0) * 1e3, 3)


def _median_ms(fn, reps: int) -> float:
    """Median wall time of fn() over reps runs, each ending in
    block_until_ready (after one warm-up call)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return round(float(np.median(ts)) * 1e3, 3)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _same_reduce(got, ids, pos, what: str) -> None:
    g_ids, g_pos, g_count = got
    _check(int(g_count) == ids.shape[0], f"{what}: count {int(g_count)} "
           f"!= {ids.shape[0]}")
    _check(np.array_equal(np.asarray(g_pos)[: ids.shape[0]], pos),
           f"{what}: positions differ")
    _check(np.array_equal(np.asarray(g_ids)[: ids.shape[0]], ids),
           f"{what}: ids differ")


class Smoke:
    def __init__(self, seed: int):
        self.seed = seed
        self.results: list[dict] = []

    def run(self, name: str, fn) -> bool:
        t0 = time.perf_counter()
        try:
            info = fn() or {}
            rec = {"phase": name, "ok": True, "ms": _ms(t0), **info}
        except Exception as e:  # report the phase, go on, fail at the end
            traceback.print_exc()
            rec = {"phase": name, "ok": False, "ms": _ms(t0),
                   "error": f"{type(e).__name__}: {e}"}
        self.results.append(rec)
        print(json.dumps(rec), flush=True)
        return rec["ok"]

    # ------------------------------------------------------------- phases
    def readme(self):
        import jax

        from pfac_tpu import Matcher
        from pfac_tpu.backends.gpu_walk import GpuWalkMatcher
        from pfac_tpu.runtime import capi
        from pfac_tpu.status import PfacStatus

        for mode in MODES:
            m = Matcher(README_PATTERNS, perf_mode=mode)
            _check(type(m._engine()) is GpuWalkMatcher, "engine is not the "
                   f"GPU walk kernel: {type(m._engine()).__name__}")
            _check(m.match(README_INPUT).tolist() == README_IDS,
                   f"{mode}: match")
            ids, pos, n = m.match_reduce(README_INPUT)
            _check((n, pos.tolist(), ids.tolist())
                   == (5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2]),
                   f"{mode}: match_reduce")
            d = jax.device_put(np.frombuffer(README_INPUT, np.uint8))
            _same_reduce(m.match_reduce_device(d), ids, pos,
                         f"{mode}: match_reduce_device")
            # the C API flow of examples/simple_example.py
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "patterns")
                with open(path, "wb") as f:
                    f.write(b"\n".join(README_PATTERNS) + b"\n")
                h = []
                ok = PfacStatus.SUCCESS
                _check(capi.PFAC_create(h) == ok, "PFAC_create")
                perf = (capi.PFAC_TIME_DRIVEN if mode == "dense"
                        else capi.PFAC_SPACE_DRIVEN)
                _check(capi.PFAC_setPerfMode(h[0], perf) == ok,
                       "PFAC_setPerfMode")
                _check(capi.PFAC_readPatternFromFile(h[0], path) == ok,
                       "PFAC_readPatternFromFile")
                n_in = len(README_INPUT)
                out = np.zeros(n_in, np.int32)
                _check(capi.PFAC_matchFromHost(h[0], README_INPUT, n_in, out)
                       == ok, "PFAC_matchFromHost")
                _check(out.tolist() == README_IDS, f"{mode}: C API result")
                _check(capi.PFAC_destroy(h[0]) == ok, "PFAC_destroy")
        return {"modes": list(MODES)}

    def setup_flagship(self):
        from pfac_tpu import Automaton
        from pfac_tpu.backends import golden
        from pfac_tpu.tools import workloads

        t0 = time.perf_counter()
        self.patterns = workloads.snort_like_patterns()
        self.automaton = Automaton.from_patterns(self.patterns)
        build_ms = _ms(t0)
        rng = np.random.default_rng(self.seed)
        n = 128 * MB
        self.corpora = {
            "random": workloads.random_bytes(rng, n),
            "defcon_1.5pct": workloads.planted_text(rng, self.patterns, n),
        }
        t0 = time.perf_counter()
        self.golden = {k: golden.match_dense_batch(self.automaton, v)
                       for k, v in self.corpora.items()}
        return {"patterns": len(self.patterns),
                "states": self.automaton.num_states,
                "max_pattern_len": self.automaton.max_pattern_len,
                "automaton_build_ms": build_ms, "golden_ms": _ms(t0),
                "corpus_bytes": n}

    def flagship(self):
        import jax

        from pfac_tpu import Matcher

        a = self.automaton
        info = {}
        self.matchers = {mode: Matcher(automaton=a, perf_mode=mode)
                         for mode in MODES}
        for cname, data in self.corpora.items():
            n = data.shape[0]
            exp = self.golden[cname]
            g_pos = np.flatnonzero(exp > 0).astype(np.int32)
            g_ids = exp[g_pos]
            dd = jax.device_put(data)
            for mode, m in self.matchers.items():
                key = f"{cname}/{mode}"
                t0 = time.perf_counter()
                out = jax.block_until_ready(m.match_device(dd))
                first_ms = _ms(t0)
                host = np.asarray(out)
                _check(np.array_equal(host[:n], exp), f"{key}: match_device")
                _check(not host[n:].any(), f"{key}: padded tail not zero")
                steady = _median_ms(lambda: m.match_device(dd), reps=5)
                t0 = time.perf_counter()
                _check(np.array_equal(m.match(data), exp), f"{key}: match")
                match_ms = _ms(t0)
                t0 = time.perf_counter()
                ids, pos, count = m.match_reduce(data)
                reduce_ms = _ms(t0)
                _check(count == g_pos.shape[0], f"{key}: match_reduce count")
                _check(np.array_equal(pos, g_pos) and np.array_equal(ids, g_ids),
                       f"{key}: match_reduce")
                t0 = time.perf_counter()
                _same_reduce(m.match_reduce_device(dd), g_ids, g_pos,
                             f"{key}: match_reduce_device")
                rdev_ms = _ms(t0)
                info[key] = {
                    "matches": int(g_pos.shape[0]),
                    "match_device_first_ms": first_ms,
                    "match_device_ms": steady,
                    "match_device_GBps": round(n / steady / 1e6, 3),
                    "match_ms": match_ms, "match_reduce_ms": reduce_ms,
                    "match_reduce_device_first_ms": rdev_ms}
        return info

    def kernel_ab(self):
        import jax
        import jax.numpy as jnp

        from pfac_tpu.backends.gpu_walk import GpuWalkMatcher
        from pfac_tpu.backends.xla import XlaMatcher

        info = {}
        for cname, data in self.corpora.items():
            n = data.shape[0]
            dd = jax.device_put(data)
            for mode in MODES:
                kern = self.matchers[mode]._engine()
                _check(type(kern) is GpuWalkMatcher, "engine is not the kernel")
                xla = XlaMatcher(self.automaton, perf_mode=mode)
                k_out, x_out = kern.match_device(dd), xla.match_device(dd)
                _check(bool(jnp.array_equal(k_out[:n], x_out[:n])),
                       f"{cname}/{mode}: kernel != walk_tiles")
                k_ms = _median_ms(lambda: kern.match_device(dd), reps=7)
                x_ms = _median_ms(lambda: xla.match_device(dd), reps=3)
                info[f"{cname}/{mode}"] = {
                    "kernel_ms": k_ms, "kernel_GBps": round(n / k_ms / 1e6, 3),
                    "walk_tiles_ms": x_ms,
                    "walk_tiles_GBps": round(n / x_ms / 1e6, 3),
                    "identical": True}
        return info

    def edges(self):
        from pfac_tpu import Automaton, Matcher
        from pfac_tpu.backends import golden
        from pfac_tpu.tools import workloads

        info = {}
        # stream: uneven chunks of the flagship text, whole-buffer result
        data = self.corpora["defcon_1.5pct"]
        exp = self.golden["defcon_1.5pct"]
        sm = self.matchers["dense"].stream()
        cuts = [0, 5 * MB + 7, 5 * MB + 8, 38 * MB + 1, 55 * MB + 123,
                90 * MB, data.shape[0]]
        parts = []
        t0 = time.perf_counter()
        for lo, hi in zip(cuts, cuts[1:]):
            start, ids = sm.feed(data[lo:hi].tobytes())
            parts.append((start, ids))
        parts.append(sm.finish())
        got = np.zeros(data.shape[0], np.int32)
        for start, ids in parts:
            got[start:start + ids.shape[0]] = ids
        _check(sum(p[1].shape[0] for p in parts) == data.shape[0],
               "stream: positions lost")
        _check(np.array_equal(got, exp), "stream != whole buffer")
        info["stream"] = {"chunks": len(cuts) - 1, "ms": _ms(t0)}

        rng = np.random.default_rng(self.seed + 1)
        virus = workloads.virus_dense(rng, self.patterns, 8 * MB)
        allmatch = np.full(64 * MB, ord("a"), np.uint8)
        cases = [("virus_dense_8MB", self.automaton, virus),
                 ("all_match_64MB", Automaton.from_patterns([b"aaaa"]),
                  allmatch)]
        for name, a, arr in cases:
            exp = golden.match_dense_batch(a, arr)
            for mode in MODES:
                t0 = time.perf_counter()
                got = Matcher(automaton=a, perf_mode=mode).match(arr)
                _check(np.array_equal(got, exp), f"{name}/{mode}")
                info[f"{name}/{mode}"] = {"matches": int((exp > 0).sum()),
                                          "first_call_ms": _ms(t0)}
        return info

    def sharded_one_card(self):
        from pfac_tpu.dist.sharding import ShardedMatcher, make_data_mesh

        mesh = make_data_mesh(1)
        data = self.corpora["defcon_1.5pct"]
        exp = self.golden["defcon_1.5pct"]
        info = {}
        for mode in MODES:
            sm = ShardedMatcher(self.automaton, mesh=mesh, perf_mode=mode)
            _check(sm.engine == "gpu", f"sharded engine {sm.engine}")
            t0 = time.perf_counter()
            got = sm.match(data)
            _check(np.array_equal(got, self.matchers[mode].match(data)),
                   f"{mode}: ShardedMatcher != Matcher")
            _check(np.array_equal(got, exp), f"{mode}: sharded != golden")
            n_exp = int((exp > 0).sum())
            _check(sm.match_count(data) == n_exp, f"{mode}: match_count")
            ids, pos, count = sm.match_reduce(data)
            g_pos = np.flatnonzero(exp > 0)
            _check(count == n_exp and np.array_equal(pos, g_pos)
                   and np.array_equal(ids, exp[g_pos]), f"{mode}: match_reduce")
            info[mode] = {"matches": n_exp, "ms": _ms(t0)}
        return info

    def multi(self, ndev: int = 4):
        import jax
        import jax.numpy as jnp

        from pfac_tpu import Automaton, Matcher
        from pfac_tpu.backends import golden
        from pfac_tpu.dist.sharding import ShardedMatcher, make_data_mesh
        from pfac_tpu.tools import workloads

        devs = jax.devices()
        _check(len(devs) >= ndev, f"--multi needs {ndev} GPUs, JAX has "
               f"{len(devs)}")
        pats = workloads.snort_like_patterns()
        a = Automaton.from_patterns(pats)
        n = 512 * MB
        data = workloads.planted_text(np.random.default_rng(self.seed), pats, n)
        sm = ShardedMatcher(a, mesh=make_data_mesh(ndev))
        _check(sm.engine == "gpu", f"sharded engine {sm.engine}")
        single = Matcher(automaton=a, device=devs[0])

        t0 = time.perf_counter()
        got = sm.match(data)
        sharded_ms = _ms(t0)
        t0 = time.perf_counter()
        ref = single.match(data)
        single_ms = _ms(t0)
        _check(np.array_equal(got, ref), "sharded != single-card Matcher")

        # golden slices at the start, every shard boundary, and the end
        shard_len = sm._shard_len(n)
        w, slack = 4 * MB, a.max_pattern_len
        spans = [(0, w)] + [(b - w, b + w) for b in
                            range(shard_len, n, shard_len)] + [(n - w, n)]
        for lo, hi in spans:
            exp = golden.match_dense_batch(a, data[lo:hi])
            keep = hi - lo if hi == n else hi - lo - slack
            _check(np.array_equal(got[lo:lo + keep], exp[:keep]),
                   f"golden slice [{lo}, {hi})")

        # device fingerprint of the sharded result against the single card
        dg = sm._put(data, shard_len)
        matches, count = sm.match_device(dg, n)

        @jax.jit
        def fingerprint(r):
            r = r[:n].astype(jnp.uint32)
            w = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
            return jnp.stack([jnp.sum(r), jnp.sum(r * w)])

        fp_sharded = np.asarray(fingerprint(matches))
        fp_single = np.asarray(fingerprint(
            single.match_device(jax.device_put(data, devs[0]))))
        _check(np.array_equal(fp_sharded, fp_single), "fingerprints differ")

        n_match = int((ref > 0).sum())
        _check(int(count) == n_match, "match_device count")
        _check(sm.match_count(data) == n_match, "match_count (psum)")
        ids, pos, c = sm.match_reduce(data)
        g_pos = np.flatnonzero(ref > 0)
        _check(c == n_match and np.array_equal(pos, g_pos)
               and np.array_equal(ids, ref[g_pos]), "match_reduce")
        match_fn = sm._match_fn(shard_len, n)
        steady = _median_ms(lambda: match_fn(sm._tables, dg), reps=5)
        return {"devices": ndev, "corpus_bytes": n, "shard_len": shard_len,
                "matches": n_match, "golden_slices": len(spans),
                "sharded_match_ms": sharded_ms, "single_match_ms": single_ms,
                "sharded_match_device_ms": steady,
                "sharded_match_device_GBps": round(n / steady / 1e6, 3)}


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from pfac_tpu.runtime import compile_cache

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    smi = _nvidia_smi()

    smoke = Smoke(args.seed)
    smoke.run("device", lambda: {"platform": dev.platform,
                                 "kind": dev.device_kind, "count": len(devs)})
    if args.multi:
        smoke.run("multi", smoke.multi)
    elif smoke.run("readme", smoke.readme) and smoke.run(
            "setup", smoke.setup_flagship) and smoke.run(
            "flagship", smoke.flagship):
        smoke.run("kernel_ab", smoke.kernel_ab)
        smoke.run("edges", smoke.edges)
        smoke.run("sharded", smoke.sharded_one_card)
    ok = all(r["ok"] for r in smoke.results) and len(smoke.results) > 1
    print(smi, flush=True)
    print(json.dumps({"ok": ok, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
