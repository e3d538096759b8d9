"""Multi-device / multi-host data-parallel matching.

The reference's distributed story lives in its test harness, not the
library: N OpenMP threads drive N GPUs over round-robin chunks, each chunk
extended by maxPatternLen+1 guard bytes so cross-boundary matches resolve,
and only the first B results of each chunk are kept
(reference: PFAC/test/omp_PFAC.cpp:317-383).

Here it is a first-class component, one program over a device mesh:

* 1-D device mesh over axis ``"data"``; the corpus is sharded across it,
  the transition tables are **replicated** (in_specs ``P()``). The cards
  of one host are joined all to all, so the mesh follows the algorithm
  alone.
* The guard bytes are a **halo exchange**: inside ``shard_map`` each
  shard sends its first ``H = max(max_pattern_len, 2)`` bytes to its
  left neighbor via ``lax.ppermute``; bytes at or past the global end of
  input are masked as end of input.
* Each shard runs the single-device walk (the GPU walk kernel on GPU
  meshes, the XLA walker elsewhere) and owns the match results for
  exactly its own byte range (the reference's "copy back first B results
  only").
* Global match counts reduce with ``psum``; ``match_reduce`` compacts
  each shard on its device and ships at most ``reduce_cap`` pairs each.

Multi-host: the same jitted function works over a multi-host mesh created
from ``jax.devices()`` after ``jax.distributed.initialize`` (one process
per host, each driving all of its local devices). See dist/multihost.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus
from ..backends import gpu_walk
from ..backends.xla import (
    SENTINEL,
    DEFAULT_TILE,
    dense_device_table,
    dense_step_fn,
    hash_device_tables,
    hash_step_fn,
    pair_tables,
    walk_tiles,
    LANES,
    _lane_prefix,
    _prefix_1d,
    _rank_rows,
    _to_u8,
)

AXIS = "data"


def shard_valid_lengths(n: int, num_devices: int, shard_len: int,
                        halo: int) -> np.ndarray:
    """Real bytes in each shard's (bytes + halo) window: int32[num_devices].

    Computed on the host in int64, since global positions pass int32 once
    the input passes 2 GiB."""
    starts = np.arange(num_devices, dtype=np.int64) * shard_len
    return np.clip(n - starts, 0, shard_len + halo).astype(np.int32)


def _compact_capped(m: jax.Array, cap: int):
    """Device-side compaction of a dense match vector into at most `cap`
    (id, pos) pairs, positions ascending. Returns (ids[cap], pos[cap],
    count) — entries past count are zero; count may exceed cap (caller
    must detect).

    One rank-select chunk of xla._reduce_rowgather: per-row match
    counts -> hierarchical prefix -> compare-sum rank search -> one
    (cap, 128) row gather, with no scatter."""
    n = m.shape[0]
    n128 = -(-n // LANES) * LANES
    if n128 != n:
        m = jnp.concatenate([m, jnp.zeros(n128 - n, m.dtype)])
    m2d = m.reshape(-1, LANES)
    counts = (m2d > 0).sum(axis=1)
    bcum = _prefix_1d(counts)
    count = bcum[-1]
    q = jnp.arange(1, cap + 1, dtype=jnp.int32)
    row, prev = _rank_rows(bcum, q)
    vals = jnp.take(m2d, row, axis=0)                # (cap, 128) row gather
    rcum = _lane_prefix(vals > 0)                    # matmul prefix, f32 exact
    within = jnp.sum((rcum < (q - prev)[:, None].astype(jnp.float32))
                     .astype(jnp.int32), axis=1)
    within = jnp.minimum(within, LANES - 1)
    cid = jnp.sum(jnp.where(jnp.arange(LANES, dtype=jnp.int32)[None, :]
                            == within[:, None], vals, 0), axis=1)
    valid = q <= count
    ids = jnp.where(valid, cid, 0).astype(jnp.int32)
    pos = jnp.where(valid, row * LANES + within, 0)
    return ids, pos, count


def make_data_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over all (or the first N) addressable devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return jax.make_mesh((len(devices),), (AXIS,), devices=devices)


@dataclasses.dataclass
class ShardedMatcher:
    """Data-parallel matcher over a device mesh.

    match(data) returns the same int32[N] result as the single-device
    matcher — sharding must be invisible in the output (the determinism
    contract of SURVEY.md §7.4).

    Each shard runs the engine of the mesh's platform (``self.engine``):
    the GPU walk kernel ("gpu") on GPU meshes, the XLA walker ("xla")
    elsewhere. ``interpret=True`` runs the GPU kernel in the Pallas
    interpreter instead (tests only).
    """

    automaton: Automaton
    mesh: Mesh | None = None
    perf_mode: str = "dense"
    tile: int = DEFAULT_TILE      # XLA walker tile
    interpret: bool = False
    reduce_cap: int = 1 << 20     # per-shard device compaction capacity

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_data_mesh()
        on_gpu = self.mesh.devices.flat[0].platform == "gpu"
        self.engine = "gpu" if on_gpu or self.interpret else "xla"
        a = self.automaton
        self._sharded_fns: dict = {}

        ps, pm = pair_tables(a)
        if self.perf_mode == "dense":
            if self.engine == "gpu":
                gpu_walk.check_dense_index(a.num_states)
            tabs = (dense_device_table(a).reshape(-1),)
        elif self.perf_mode == "hash":
            t = hash_device_tables(a)
            tabs = (t["rp_off"], t["rp_key"], t["val_next"], t["val_ch"])
        else:
            raise ValueError(f"unknown perf_mode {self.perf_mode!r}")
        rep = NamedSharding(self.mesh, P())
        self._tables = tuple(jax.device_put(jnp.asarray(x), rep)
                             for x in (ps, pm) + tabs)

    # ------------------------------------------------------------ internals
    @property
    def num_devices(self) -> int:
        return self.mesh.devices.size

    @property
    def _unit(self) -> int:
        """Start positions per walk program: shard lengths are multiples."""
        return gpu_walk.DEFAULT_BLOCK if self.engine == "gpu" else self.tile

    def _halo(self) -> int:
        return max(self.automaton.max_pattern_len, 2)

    def _shard_len(self, n: int) -> int:
        """Bytes per shard: ceil(n / ndev), at least one halo, rounded up
        to a walk-unit multiple."""
        per = max(-(-n // self.num_devices), self._halo())
        shard_len = -(-per // self._unit) * self._unit
        if shard_len + self._halo() > gpu_walk.MAX_INPUT_BYTES:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                f"{shard_len} bytes per shard exceed the int32 position "
                "range; use more devices or stream the input",
            )
        return shard_len

    def _local_walk(self, shard_len: int):
        """(tables, ext_u8, n_valid) -> int32[shard_len]: the single-device
        walk over this shard's bytes plus halo, reads at or past n_valid
        being end of input."""
        a = self.automaton
        if self.engine == "gpu":
            kw = dict(mode=self.perf_mode, num_final=a.num_final_states,
                      max_len=a.max_pattern_len, num_out=shard_len,
                      interpret=self.interpret)

            def walk(tables, ext, n_valid):
                ps, pm, *tabs = tables
                return gpu_walk.walk(tuple(tabs), ps, pm, ext,
                                     n_valid.reshape(1), **kw)

            return walk

        mk_step = dense_step_fn if self.perf_mode == "dense" else hash_step_fn
        tile = self.tile

        def walk(tables, ext, n_valid):
            ps, pm, *tabs = tables
            pos = jnp.arange(ext.shape[0], dtype=jnp.int32)
            inp = jnp.where(pos < n_valid, ext.astype(jnp.int32), SENTINEL)
            return walk_tiles(
                mk_step(*tabs), ps, pm, inp,
                num_final=a.num_final_states, max_len=a.max_pattern_len,
                tile=tile, num_tiles=shard_len // tile,
            )

        return walk

    def _shard_map(self, local_fn, out_specs):
        # pallas_call out_shapes carry no varying-mesh-axes annotation
        return jax.jit(jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=(P(), P(AXIS)),
            out_specs=out_specs, check_vma=self.engine != "gpu",
        ))

    def _local_matches(self, shard_len: int, n: int):
        """Per-shard body: halo exchange, then the walk over owned bytes."""
        halo = self._halo()
        nd = self.num_devices
        walk = self._local_walk(shard_len)
        # the last shard's halo and the host zero-pad lie at or past n
        valid = shard_valid_lengths(n, nd, shard_len, halo)

        def local(tables, data_local):
            idx = jax.lax.axis_index(AXIS)
            head = data_local[:halo]           # my head -> left neighbor
            perm = [(i, i - 1) for i in range(1, nd)]
            halo_bytes = jax.lax.ppermute(head, AXIS, perm) if perm else head
            ext = jnp.concatenate([data_local, halo_bytes])
            return walk(tables, ext, jnp.asarray(valid)[idx])

        return local

    def _cached(self, key, build):
        fn = self._sharded_fns.get(key)
        if fn is None:
            fn = self._sharded_fns[key] = build()
        return fn

    def _match_fn(self, shard_len: int, n: int):
        return self._cached(("match", shard_len, n), lambda: self._shard_map(
            self._local_matches(shard_len, n), P(AXIS)))

    def _count_fn(self):
        def count(matches):
            return jax.lax.psum(jnp.sum(matches > 0), AXIS)

        return self._cached("count", lambda: jax.jit(jax.shard_map(
            count, mesh=self.mesh, in_specs=(P(AXIS),), out_specs=P())))

    def _reduce_fn(self, shard_len: int, n: int, cap: int):
        local = self._local_matches(shard_len, n)

        def local_reduce(tables, data_local):
            ids, pos, count = _compact_capped(local(tables, data_local), cap)
            return ids, pos, count.reshape(1)

        return self._cached(("reduce", shard_len, n, cap), lambda: self._shard_map(
            local_reduce, (P(AXIS), P(AXIS), P(AXIS))))

    def _put(self, arr: np.ndarray, shard_len: int) -> jax.Array:
        total = shard_len * self.num_devices
        padded = np.zeros(total, dtype=np.uint8)
        padded[: arr.shape[0]] = arr
        return jax.device_put(padded, NamedSharding(self.mesh, P(AXIS)))

    # ------------------------------------------------------------ public
    def match_device(self, data_u8_global: jax.Array, n: int):
        """data_u8_global: uint8[ndev*shard_len] already sharded over the
        mesh, with ``shard_len == self._shard_len(n)``.

        Returns (matches int32[ndev*shard_len] sharded, count replicated).
        """
        shard_len = self._shard_len(n)
        matches = self._match_fn(shard_len, n)(self._tables, data_u8_global)
        return matches, self._count_fn()(matches)

    def match(self, data) -> np.ndarray:
        arr = _to_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        shard_len = self._shard_len(n)
        matches = self._match_fn(shard_len, n)(
            self._tables, self._put(arr, shard_len))
        return np.asarray(matches)[:n]

    def match_count(self, data) -> int:
        """Global number of matching positions (psum over the mesh)."""
        arr = _to_u8(data)
        n = arr.shape[0]
        if n == 0:
            return 0
        _, count = self.match_device(self._put(arr, self._shard_len(n)), n)
        return int(count)

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        """Compacted (ids, positions, count), positions ascending globally.

        Each shard compacts its own matches on its device (row-gather
        rank select) and ships at most `reduce_cap` pairs — the dense
        result never reaches the host. Positions are int64: inputs
        >= 2^31 bytes are exactly what the sharded path exists for. If a
        shard holds more than `reduce_cap` matches, the dense path runs
        instead."""
        arr = _to_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int64), 0
        shard_len = self._shard_len(n)
        cap = min(self.reduce_cap, shard_len)
        ids, pos, counts = self._reduce_fn(shard_len, n, cap)(
            self._tables, self._put(arr, shard_len))
        counts = np.asarray(counts)
        if (counts > cap).any():
            m = self.match(arr)
            gpos = np.flatnonzero(m > 0)
            return m[gpos].astype(np.int32), gpos, int(gpos.shape[0])
        ids = np.asarray(ids).reshape(self.num_devices, cap)
        pos = np.asarray(pos).reshape(self.num_devices, cap)
        base = np.arange(self.num_devices, dtype=np.int64) * shard_len
        gi = np.concatenate([ids[s, :c] for s, c in enumerate(counts)])
        gp = np.concatenate([pos[s, :c].astype(np.int64) + base[s]
                             for s, c in enumerate(counts)])
        return gi.astype(np.int32), gp, int(gp.shape[0])
