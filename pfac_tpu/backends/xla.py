"""Portable XLA matcher: jit-compiled vectorized failureless-AC walks,
and the device tables every engine shares.

A lockstep re-design of the reference's CUDA kernels
(reference: PFAC/src/PFAC_kernel.cu:377-458,
PFAC/src/PFAC_kernel_spaceDriven.cu:465-558) that any XLA backend runs;
it is the engine off the GPU (the GPU runs backends/gpu_walk.py):

* **Trap = state 0.** The reference breaks out of the walk on a trap
  sentinel (0xFFFFFFFF). A vectorized walk has no per-lane branch, so
  we renumber: device row 0 is all zeros and every trap edge points at 0.
  A trapped lane self-loops at 0 forever; no masks, no per-lane control
  flow. The "record last final state" update is a single select:
  ``match = where((1 <= s) & (s <= K), s, match)``.

* **Sentinel column 257.** Device tables have 257 columns; the input is
  padded with byte value 256 whose column is all-trap. Walks running off
  the end of the input die on the sentinel — the inner loop needs no
  bounds check at all (the reference needs `pos < input_size` per step).

* **Fused first-two-steps table.** The reference stages the initial-state
  row in shared memory because most walks die within a step or two
  (PFAC_kernel.cu:398-403). We go further: a 257x257 table gives the state
  *and* the best match after the first two bytes in one gather. Lanes that
  die in <= 2 steps (the overwhelming majority for realistic rule sets)
  never touch the big table.

* **Tiled early exit.** Lanes are processed in tiles of T start positions;
  a `lax.while_loop` per tile exits as soon as every lane in the tile has
  trapped — the lockstep analog of the reference's per-thread `break`.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.automaton import Automaton
from ..core.tables import HASH_KEY_K_MASKBITS, HASH_KEY_S_MASK
from ..core.trie import CHAR_SET, TRAP_STATE

SENTINEL = CHAR_SET  # 256: the padding byte value; column 256 is all-trap
STRIDE = CHAR_SET + 1  # 257 columns in device tables
DEFAULT_TILE = 1 << 17  # 128K start positions per tile
LANES = 128             # row width of the reduce's rank searches


# --------------------------------------------------------------------------
# Device table preparation (host-side, NumPy; uploaded once per automaton)
# --------------------------------------------------------------------------

def dense_device_table(automaton: Automaton) -> np.ndarray:
    """Dense device table int32[S, 257]: trap -> 0, row 0 = 0, col 256 = 0.

    Built straight from the trie's edge list over a calloc'd zero array —
    the trap entries are implicit, so no O(S*256) fill pass is needed
    (np.full on half-GB tables costs seconds).
    """
    if automaton.trie is not None:
        e = automaton.trie.edges_array()
        dev = np.zeros((automaton.num_states, STRIDE), dtype=np.int32)
        if e.size:
            dev[e[:, 0], e[:, 1]] = e[:, 2]
        dev[0, :] = 0
        return dev
    src = automaton.ensure_dense().table  # [S, 256], trap = -1
    s = src.shape[0]
    dev = np.zeros((s, STRIDE), dtype=np.int32)
    dev[:, :CHAR_SET] = np.where(src == TRAP_STATE, 0, src)
    dev[0, :] = 0
    return dev


def pair_tables(automaton: Automaton) -> tuple[np.ndarray, np.ndarray]:
    """Fused two-byte tables, each int32[257*257] flat.

    pair_state[c1*257+c2] = device state after reading (c1, c2) from the
    initial state; pair_match[...] = best (longest) match ID within those
    two bytes. c1 or c2 == 256 encodes "past end of input".
    """
    dev = dense_device_table(automaton)
    k = automaton.num_final_states
    init = automaton.initial_state

    c1 = np.arange(STRIDE, dtype=np.int64)
    s1 = np.where(c1 < CHAR_SET, dev[init, np.minimum(c1, CHAR_SET - 1)], 0)
    s1[SENTINEL] = 0
    m1 = np.where((s1 >= 1) & (s1 <= k), s1, 0)

    s2 = dev[s1[:, None], np.arange(STRIDE)[None, :]]  # [257, 257]
    m2 = np.where((s2 >= 1) & (s2 <= k), s2, m1[:, None])
    return (
        s2.astype(np.int32).reshape(-1),
        m2.astype(np.int32).reshape(-1),
    )


def hash_device_tables(automaton: Automaton) -> dict[str, np.ndarray]:
    """Hashed device tables with the same trap-=-0 renumbering.

    Empty rows (offset -1) are redirected to a dedicated poison slot at
    index E whose stored char (-1) never equals any input byte, so the
    probe's verify-select yields 0 — again branch-free.
    """
    ht = automaton.ensure_hash()
    e = ht.val.shape[0]

    rp_off = ht.row_ptr[:, 0].astype(np.int32).copy()
    rp_key = ht.row_ptr[:, 1].astype(np.int32).copy()
    empty = rp_off < 0
    rp_off[empty] = e
    rp_key[empty] = 0  # k = 0, s-1 = 0 -> always probes the poison slot
    # state 0 (device trap) must self-trap: poison its row too
    rp_off[0] = e
    rp_key[0] = 0

    val_next = np.zeros(e + 1, dtype=np.int32)
    val_ch = np.full(e + 1, -1, dtype=np.int32)
    val_next[:e] = np.where(ht.val[:, 0] == TRAP_STATE, 0, ht.val[:, 0])
    val_ch[:e] = ht.val[:, 1]
    # empty hash slots hold ch = -1 already (never matches an input byte)
    return {
        "rp_off": rp_off,
        "rp_key": rp_key,
        "val_next": val_next,
        "val_ch": val_ch,
    }


# --------------------------------------------------------------------------
# jitted matchers
# --------------------------------------------------------------------------

def _pad_len(n: int, tile: int, max_len: int) -> tuple[int, int]:
    num_tiles = max(1, -(-n // tile))
    return num_tiles, num_tiles * tile + max(max_len, 2)


def dense_step_fn(table_flat: jax.Array):
    """One automaton step for a vector of lanes, dense encoding."""

    def step(state: jax.Array, ch: jax.Array) -> jax.Array:
        return jnp.take(table_flat, state * STRIDE + ch)

    return step


def hash_step_fn(rp_off, rp_key, val_next, val_ch):
    """One automaton step via the modulo-free perfect-hash probe."""

    def step(state: jax.Array, ch: jax.Array) -> jax.Array:
        off_row = jnp.take(rp_off, state)
        key = jnp.take(rp_key, state)
        # modulo-free (k*ch) mod 257: x = 256q + r  ==>  r - q (mod 257)
        x = (key >> HASH_KEY_K_MASKBITS) * ch
        beta = (x & 0xFF) - (x >> 8)
        beta = jnp.where(beta < 0, beta + 257, beta)
        slot = off_row + (beta & (key & HASH_KEY_S_MASK))
        nxt = jnp.take(val_next, slot)
        stored = jnp.take(val_ch, slot)
        return jnp.where(stored == ch, nxt, 0)

    return step


def walk_tiles(
    step,                      # (state_vec, ch_vec) -> next_state_vec
    pair_state: jax.Array,     # int32 [257*257]
    pair_match: jax.Array,     # int32 [257*257]
    inp: jax.Array,            # int32 [num_tiles*tile + pad], sentinel-ized
    *,
    num_final: int,
    max_len: int,
    tile: int,
    num_tiles: int,
) -> jax.Array:
    """Run failureless walks from every position of a sentinel-padded int32
    input. Shared by the single-device matchers and the sharded path; the
    caller guarantees `inp[j] == SENTINEL` for every j past the true end of
    data (walks die there with no bounds checks)."""

    def tile_body(carry, off):
        c1 = jax.lax.dynamic_slice(inp, (off,), (tile,))
        c2 = jax.lax.dynamic_slice(inp, (off + 1,), (tile,))
        state = jnp.take(pair_state, c1 * STRIDE + c2)
        match = jnp.take(pair_match, c1 * STRIDE + c2)

        def cond(sc):
            d, state, _ = sc
            return jnp.logical_and(d < max_len, jnp.any(state > 0))

        def body(sc):
            d, state, match = sc
            ch = jax.lax.dynamic_slice(inp, (off + d,), (tile,))
            state = step(state, ch)
            match = jnp.where((state > 0) & (state <= num_final), state, match)
            return d + 1, state, match

        if max_len > 2:
            _, _, match = jax.lax.while_loop(cond, body, (jnp.int32(2), state, match))
        return carry, match

    offsets = jnp.arange(num_tiles, dtype=jnp.int32) * tile
    _, matches = jax.lax.scan(tile_body, None, offsets)
    return matches.reshape(num_tiles * tile)


def sentinel_pad(data_u8: jax.Array, padded: int) -> jax.Array:
    """uint8[N] -> int32[padded] with SENTINEL past position N."""
    inp = jnp.full(padded, SENTINEL, dtype=jnp.int32)
    return jax.lax.dynamic_update_slice(inp, data_u8.astype(jnp.int32), (0,))


@functools.partial(jax.jit, static_argnames=("num_final", "max_len", "tile", "num_tiles"))
def _match_dense_padded(
    table_flat: jax.Array,      # int32 [S*257]
    pair_state: jax.Array,      # int32 [257*257]
    pair_match: jax.Array,      # int32 [257*257]
    data_u8: jax.Array,         # uint8 [N]
    *,
    num_final: int,
    max_len: int,
    tile: int,
    num_tiles: int,
) -> jax.Array:
    _, padded = _pad_len(data_u8.shape[0], tile, max_len)
    inp = sentinel_pad(data_u8, padded)
    return walk_tiles(
        dense_step_fn(table_flat), pair_state, pair_match, inp,
        num_final=num_final, max_len=max_len, tile=tile, num_tiles=num_tiles,
    )


@functools.partial(jax.jit, static_argnames=("num_final", "max_len", "tile", "num_tiles"))
def _match_hash_padded(
    rp_off: jax.Array,
    rp_key: jax.Array,
    val_next: jax.Array,
    val_ch: jax.Array,
    pair_state: jax.Array,
    pair_match: jax.Array,
    data_u8: jax.Array,
    *,
    num_final: int,
    max_len: int,
    tile: int,
    num_tiles: int,
) -> jax.Array:
    _, padded = _pad_len(data_u8.shape[0], tile, max_len)
    inp = sentinel_pad(data_u8, padded)
    return walk_tiles(
        hash_step_fn(rp_off, rp_key, val_next, val_ch), pair_state, pair_match,
        inp, num_final=num_final, max_len=max_len, tile=tile, num_tiles=num_tiles,
    )


@jax.jit
def _reduce_padded(match_padded: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Stream compaction of a dense match vector (unused: the plain arm
    for a later comparison with `_reduce_rowgather`).

    Replacement for the reference's two-kernel ballot/scan/zip
    pipeline (reference: PFAC/src/PFAC_reduce_kernel.cu:306-457) — XLA's
    fused cumsum + scatter needs none of the hand-rolled semaphore
    machinery. Returns (ids, positions, count) with positions ascending;
    entries past `count` are undefined (API slices them off).
    """
    match_padded = match_padded.astype(jnp.int32)
    n = match_padded.shape[0]
    flags = match_padded > 0
    idx = jnp.cumsum(flags) - 1          # output slot per matching lane
    count = jnp.where(n > 0, idx[-1] + 1, 0).astype(jnp.int32)
    scatter_to = jnp.where(flags, idx, n)  # out-of-range slots are dropped
    pos = jnp.zeros(n, dtype=jnp.int32).at[scatter_to].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    ids = jnp.zeros(n, dtype=jnp.int32).at[scatter_to].set(
        match_padded, mode="drop"
    )
    return ids, pos, count


# --------------------------------------------------------------------------
# Host-facing wrapper
# --------------------------------------------------------------------------

@dataclasses.dataclass
class XlaMatcher:
    """Holds device-resident tables and dispatches jitted matchers."""

    automaton: Automaton
    perf_mode: str = "dense"      # "dense" | "hash"
    tile: int = DEFAULT_TILE
    device: jax.Device | None = None

    def __post_init__(self):
        dev = self.device
        put = lambda x: jax.device_put(jnp.asarray(x), dev)
        ps, pm = pair_tables(self.automaton)
        self._pair_state = put(ps)
        self._pair_match = put(pm)
        if self.perf_mode == "dense":
            self._table_flat = put(dense_device_table(self.automaton).reshape(-1))
        elif self.perf_mode == "hash":
            t = hash_device_tables(self.automaton)
            self._rp_off = put(t["rp_off"])
            self._rp_key = put(t["rp_key"])
            self._val_next = put(t["val_next"])
            self._val_ch = put(t["val_ch"])
        else:
            raise ValueError(f"unknown perf_mode {self.perf_mode!r}")

    # ---- device-array in, device-array out (PFAC_matchFromDevice analog)
    def match_device(self, data_u8: jax.Array) -> jax.Array:
        """data_u8: uint8[N] on device -> int32[N_padded] match ids.

        The padded tail (sentinel region) always reports 0.
        """
        n = int(data_u8.shape[0])
        num_tiles, _ = _pad_len(n, self.tile, self.automaton.max_pattern_len)
        kw = dict(
            num_final=self.automaton.num_final_states,
            max_len=self.automaton.max_pattern_len,
            tile=self.tile,
            num_tiles=num_tiles,
        )
        if self.perf_mode == "dense":
            return _match_dense_padded(
                self._table_flat, self._pair_state, self._pair_match, data_u8, **kw
            )
        return _match_hash_padded(
            self._rp_off, self._rp_key, self._val_next, self._val_ch,
            self._pair_state, self._pair_match, data_u8, **kw
        )

    def match(self, data) -> np.ndarray:
        """bytes in, int32[N] out (PFAC_matchFromHost analog)."""
        arr = _to_u8(data)
        n = arr.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        out = self.match_device(jax.device_put(arr, self.device))
        return np.asarray(out)[:n]

    def match_reduce_device(self, data_u8: jax.Array):
        m = self.match_device(data_u8)
        return _reduce_rowgather(m)

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        return host_reduce(self.match(data))


@functools.lru_cache(maxsize=1)
def _prefix_mat():
    return np.triu(np.ones((LANES, LANES), np.float32))


def _lane_prefix(x2d: jax.Array) -> jax.Array:
    """Inclusive prefix sum along the 128-lane minor axis, as ONE
    matmul against a triangular ones matrix. Returns f32 (exact for
    sums < 2^24).

    precision=HIGHEST is LOAD-BEARING: a GPU's default f32 dot runs in
    TF32 (10 mantissa bits), which rounds the INPUTS, so an integer row
    count above 2048 with low bits set would round and the prefix would
    be silently off by a few units. HIGHEST keeps the exact f32 form;
    the matrix is 128x128, so the extra cost is noise."""
    return jnp.dot(x2d.astype(jnp.float32), jnp.asarray(_prefix_mat()),
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


_PREFIX_1D_LEAF = 1 << 14


def _prefix_1d(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum of a 1-D int32 vector, hierarchically:
    per-128-lane matmul prefixes (one linear pass) + a recursive prefix
    over the row totals: two linear passes.

    Exactness: the in-row prefix rides f32 (exact while every 128-lane
    row SUM < 2^24) — callers pass small per-element values (match flags,
    row counts). Cross-row offsets are int32."""
    n = x.shape[0]
    if n <= _PREFIX_1D_LEAF:
        return jnp.cumsum(x)
    nr = -(-n // LANES)
    if nr * LANES != n:
        x = jnp.concatenate([x, jnp.zeros(nr * LANES - n, x.dtype)])
    x2 = x.reshape(nr, LANES)
    p = _lane_prefix(x2).astype(jnp.int32)          # inclusive, per row
    tot = p[:, LANES - 1]
    off = _prefix_1d(tot) - tot                     # exclusive row offsets
    return (p + off[:, None]).reshape(-1)[:n]


def _rank_rows(bcum: jax.Array, q: jax.Array):
    """searchsorted(bcum, q) + the preceding cumulative value, built from
    row gathers and compare-sums only, instead of ~log2(nb) elementwise
    gathers per rank for a binary search.

    Returns (row, prev) with row = first index where bcum[row] >= q
    (clamped to nb-1) and prev = bcum[row-1] (0 when row == 0)."""
    nb = bcum.shape[0]
    if nb <= LANES:
        rows = jnp.broadcast_to(bcum[None, :], (q.shape[0], nb))
        rib = jnp.sum((rows < q[:, None]).astype(jnp.int32), axis=1)
        row = jnp.minimum(rib, nb - 1)
        prev = jnp.sum(
            jnp.where(jnp.arange(nb, dtype=jnp.int32)[None, :]
                      == (rib - 1)[:, None], rows, 0), axis=1)
        return row, prev
    nc = -(-nb // LANES)
    pad = jnp.broadcast_to(bcum[-1:], (nc * LANES - nb,))
    b2 = jnp.concatenate([bcum, pad]).reshape(nc, LANES)
    ccum = b2[:, -1]                                    # (nc,) block ends
    # recurse on the block-end array: a flat (cap, nc) compare matrix
    # materializes ~1 GB when nc is large (512K-row reduce tables)
    cblk, coarse_prev = _rank_rows(ccum, q)
    rows = jnp.take(b2, cblk, axis=0)                   # (cap, LANES)
    rib = jnp.sum((rows < q[:, None]).astype(jnp.int32), axis=1)
    rib = jnp.minimum(rib, LANES - 1)
    row = jnp.minimum(cblk * LANES + rib, nb - 1)
    lane_prev = jnp.sum(
        jnp.where(jnp.arange(LANES, dtype=jnp.int32)[None, :]
                  == (rib - 1)[:, None], rows, 0), axis=1)
    prev = jnp.where(rib > 0, lane_prev, coarse_prev)   # both 0 at row 0
    return row, prev


@functools.partial(jax.jit, static_argnames=("cap",))
def _reduce_rowgather(match_padded: jax.Array, *, cap: int = 1 << 16):
    """Stream compaction built from row gathers + cumsums only.

    An alternative to the plain cumsum+scatter (`_reduce_padded`) that
    avoids elementwise scatter. This version walks the output in chunks
    of `cap` ranks: per-row (128-lane) match counts give a
    cumulative histogram; each rank binary-searches its row (cheap: the
    search table is rows-long, not elements-long), row-gathers the 128-wide
    row, and localizes the hit with an in-row cumsum. All heavy traffic is
    row-shaped. Returns (ids, pos, count) with positions ascending;
    entries past count are undefined.
    """
    match_padded = match_padded.astype(jnp.int32)
    n = match_padded.shape[0]
    n128 = -(-n // 128) * 128
    if n128 != n:
        match_padded = jnp.concatenate(
            [match_padded, jnp.zeros(n128 - n, jnp.int32)])
    nrows = n128 // 128
    m2d = match_padded.reshape(nrows, 128)
    flags = (m2d > 0).astype(jnp.int32)
    counts = flags.sum(axis=1)                       # (nrows,)
    bcum = _prefix_1d(counts)
    count = bcum[-1]

    # slack so the final chunk's fixed-width write never clamps backwards
    n_alloc = n128 + cap
    ids0 = jnp.zeros(n_alloc, jnp.int32)
    pos0 = jnp.zeros(n_alloc, jnp.int32)

    def chunk_body(state):
        i, ids, pos = state
        q = i * cap + jnp.arange(1, cap + 1, dtype=jnp.int32)
        # two-level compare-sum rank search: row gathers + compares only
        row, prev = _rank_rows(bcum, q)
        rank = q - prev
        vals = jnp.take(m2d, row, axis=0)            # (cap,128) row gather
        rcum = _lane_prefix(vals > 0)                # matmul prefix, f32
        within = jnp.sum((rcum < rank[:, None].astype(jnp.float32))
                         .astype(jnp.int32), axis=1)
        within = jnp.minimum(within, 127)
        cid = jnp.sum(jnp.where(jnp.arange(128, dtype=jnp.int32)[None, :]
                                == within[:, None], vals, 0), axis=1)
        cpos = row * 128 + within
        valid = q <= count
        cid = jnp.where(valid, cid, 0)
        cpos = jnp.where(valid, cpos, 0)
        ids = jax.lax.dynamic_update_slice(ids, cid, (i * cap,))
        pos = jax.lax.dynamic_update_slice(pos, cpos, (i * cap,))
        return i + 1, ids, pos

    def chunk_cond(state):
        i, _, _ = state
        return i * cap < count

    def chunked(_):
        _, ids, pos = jax.lax.while_loop(
            chunk_cond, chunk_body, (jnp.int32(0), ids0, pos0))
        return ids[:n128], pos[:n128]

    def dense_scatter(_):
        # match-saturated vectors: the chunk loop's per-rank search work
        # scales with count, so past ~1/8 density the one-shot
        # (flat-cost) cumsum+scatter is used
        flags = match_padded > 0
        idx = _prefix_1d(flags.astype(jnp.int32)) - 1
        scatter_to = jnp.where(flags, idx, n128)
        pos = jnp.zeros(n128, dtype=jnp.int32).at[scatter_to].set(
            jnp.arange(n128, dtype=jnp.int32), mode="drop")
        ids = jnp.zeros(n128, dtype=jnp.int32).at[scatter_to].set(
            match_padded, mode="drop")
        return ids, pos

    ids, pos = jax.lax.cond(count > n128 // 8, dense_scatter, chunked, None)
    return ids[:n], pos[:n], count


def host_reduce(match: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Compacted (ids, positions, count) from a dense host match vector.

    The host-facing reduce transfers the dense result anyway (it is the
    `PFAC_matchFromHostReduce` analog), so compaction happens host-side.
    `match_reduce_device` keeps the on-device variant for
    device-resident consumers.
    """
    pos = np.flatnonzero(match > 0).astype(np.int32)
    return match[pos].astype(np.int32), pos, int(pos.shape[0])


def _to_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected bytes or uint8 array, got {arr.dtype}")
    return arr
