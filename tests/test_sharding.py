"""Distributed matching on the virtual 8-device CPU mesh.

The determinism contract: sharded results must equal single-device results
byte-for-byte, including matches spanning shard boundaries (the halo path)
— the equivalent of the reference's multi-GPU verification loop
(reference: PFAC/test/omp_PFAC.cpp:396-439). Shards run the XLA walker
("xla", the CPU engine) or the GPU walk kernel in interpret mode ("gpu").
"""
import jax
import numpy as np
import pytest

from pfac_tpu import Automaton
from pfac_tpu.backends import golden
from pfac_tpu.dist.sharding import ShardedMatcher, make_data_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return make_data_mesh(8)


class TestShardedMatcher:
    def test_readme_example(self, mesh8, example_pattern_path, example_input):
        a = Automaton.from_pattern_file(example_pattern_path)
        sm = ShardedMatcher(a, mesh=mesh8, tile=4)
        assert sm.match(example_input).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]

    def test_boundary_spanning_matches(self, mesh8):
        # pattern crosses every shard boundary: halo exchange must resolve it
        a = Automaton.from_patterns([b"xyzw"])
        tile = 8
        n = 8 * tile  # one tile per device
        data = bytearray(b"a" * n)
        for b in range(tile - 2, n - 4, tile):  # straddle each boundary
            data[b : b + 4] = b"xyzw"
        data = bytes(data)
        sm = ShardedMatcher(a, mesh=mesh8, tile=tile)
        expected = golden.match_dense(a, data)
        assert sm.match(data).tolist() == expected.tolist()

    @pytest.mark.parametrize("perf_mode", ["dense", "hash"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_vs_golden(self, mesh8, perf_mode, seed):
        rng = np.random.default_rng(seed)
        alpha = rng.integers(0, 256, size=4).astype(np.uint8)
        pats = [
            bytes(alpha[rng.integers(0, 4, size=int(rng.integers(1, 7)))])
            for _ in range(int(rng.integers(1, 8)))
        ]
        data = bytes(alpha[rng.integers(0, 4, size=333)])
        a = Automaton.from_patterns(pats, hashed=(perf_mode == "hash"))
        sm = ShardedMatcher(a, mesh=mesh8, perf_mode=perf_mode, tile=16)
        expected = golden.match_dense(a, data)
        got = sm.match(data)
        assert got.tolist() == expected.tolist()

    def test_match_count_psum(self, mesh8):
        a = Automaton.from_patterns([b"ab"])
        data = b"ab" * 64
        sm = ShardedMatcher(a, mesh=mesh8, tile=8)
        assert sm.match_count(data) == 64

    def test_match_reduce(self, mesh8):
        a = Automaton.from_patterns([b"AB", b"ABG", b"BEDE", b"ED"])
        sm = ShardedMatcher(a, mesh=mesh8, tile=4)
        ids, pos, n = sm.match_reduce(b"ABEDEDABG")
        assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2])

    def test_input_smaller_than_mesh(self, mesh8):
        a = Automaton.from_patterns([b"ab"])
        sm = ShardedMatcher(a, mesh=mesh8, tile=4)
        assert sm.match(b"ab").tolist() == [1, 0]

    def test_subset_mesh(self):
        a = Automaton.from_patterns([b"ab"])
        mesh2 = make_data_mesh(2)
        sm = ShardedMatcher(a, mesh=mesh2, tile=8)
        data = b"xxabxx" * 10
        assert sm.match(data).tolist() == golden.match_dense(a, data).tolist()


ENGINES = ["xla", "gpu"]


def _sharded(a, mesh, engine, **kw):
    """ShardedMatcher on `engine`; the GPU kernel runs interpreted here."""
    return ShardedMatcher(a, mesh=mesh, interpret=(engine == "gpu"), **kw)


class TestShardedWalk:
    """Both per-shard walks under shard_map, on corpora that stress the
    halo and every-lane-alive walks."""

    @pytest.mark.parametrize("engine", ENGINES)
    def test_auto_engine_on_cpu_mesh_is_xla(self, mesh8, engine):
        a = Automaton.from_patterns([b"ab"])
        assert ShardedMatcher(a, mesh=mesh8).engine == "xla"
        assert _sharded(a, mesh8, engine).engine == engine

    @pytest.mark.parametrize("perf_mode", ["dense", "hash"])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_boundary_matches_vs_golden(self, mesh8, engine, perf_mode):
        rng = np.random.default_rng(3)
        pats = [b"q", b"qw", b"qwe", b"qwert", b"hello", b"lo wor"]
        a = Automaton.from_patterns(pats)
        sm = _sharded(a, mesh8, engine, perf_mode=perf_mode, tile=256)
        n = 8 * 512 + 123
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
        sl = sm._shard_len(n)
        for b in range(sl, n - 8, sl):          # straddle every shard boundary
            data[b - 3:b + 3] = b"qwerth"[:6]
        data[:5] = b"hello"
        data[-5:] = b"hello"
        data = bytes(data)
        expected = golden.match_dense(a, data)
        assert np.array_equal(sm.match(data), expected)
        assert sm.match_count(data) == int((expected > 0).sum())

    @pytest.mark.parametrize("engine", ENGINES)
    def test_pathological_corpus_handled(self, mesh8, engine):
        # every position alive to depth 7 in every shard
        a = Automaton.from_patterns([b"aaaaaaa"])
        sm = _sharded(a, mesh8, engine, tile=256)
        data = b"a" * (8 * 600)
        expected = golden.match_dense(a, data)
        assert np.array_equal(sm.match(data), expected)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_all_match_across_shards(self, mesh8, engine):
        a = Automaton.from_patterns([b"aaaa", b"a" * 40, b"abab"])
        sm = _sharded(a, mesh8, engine, tile=256)
        n = 8 * 512 + 77
        d = np.full(n, ord("a"), np.uint8)
        d[3000:3010] = ord("b")
        exp = golden.match_dense_batch(a, bytes(d))
        assert np.array_equal(sm.match(bytes(d)), exp)
        assert sm.match_count(bytes(d)) == int((exp > 0).sum())

    @pytest.mark.parametrize("engine", ENGINES)
    def test_virus_dense_corpus(self, mesh8, engine):
        rng = np.random.default_rng(5)
        pats = [bytes(rng.integers(97, 103, size=int(rng.integers(2, 30)))
                      .astype(np.uint8)) for _ in range(40)]
        a = Automaton.from_patterns(pats)
        sm = _sharded(a, mesh8, engine, perf_mode="hash", tile=256)
        data = b"".join(pats[int(i)] for i in rng.integers(0, 40, size=300))
        exp = golden.match_dense_batch(a, data)
        assert np.array_equal(sm.match(data), exp)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_halo_longer_than_even_split(self, mesh8, engine):
        # a 300-byte pattern over a 900-byte corpus: every shard is at
        # least one halo long, so the ppermute halo still covers a walk
        pat = bytes(range(32, 132)) * 3
        a = Automaton.from_patterns([pat, pat[:5]])
        sm = _sharded(a, mesh8, engine, tile=128)
        data = b"xx" + pat + b"y" * 300 + pat[:250]
        exp = golden.match_dense_batch(a, data)
        assert sm._shard_len(len(data)) >= 300
        assert np.array_equal(sm.match(data), exp)


class TestMultihostGlue:
    """dist/multihost.py helpers on the virtual mesh (single process owning
    all 8 'hosts'' devices — the shard-slice math must still hold)."""

    def test_host_shard_slice_covers_everything(self, mesh8):
        from pfac_tpu.dist import multihost

        shard_len = 128
        n_total = 8 * shard_len
        start, stop = multihost.host_shard_slice(n_total, shard_len)
        assert (start, stop) == (0, n_total)  # this process owns all devices

    def test_put_host_shards_roundtrip(self, mesh8):
        import jax
        import numpy as np

        from pfac_tpu.dist import multihost

        a = Automaton.from_patterns([b"ab"])
        sm = ShardedMatcher(a, mesh=mesh8, tile=8)
        total = 8 * 16
        local = np.arange(total, dtype=np.uint8)
        arr = multihost.put_host_shards(sm, local, total)
        assert arr.shape == (total,)
        assert np.array_equal(np.asarray(arr), local)


class TestShardLayout:
    def test_valid_lengths_past_int32(self):
        # a 5 GiB input over 4 shards: global offsets pass 2**31
        from pfac_tpu.dist.sharding import shard_valid_lengths

        shard, halo = 1_342_177_280, 97
        n = 5 * (1 << 30)
        got = shard_valid_lengths(n, 4, shard, halo)
        assert got.dtype == np.int32
        assert got.tolist() == [shard + halo] * 3 + [n - 3 * shard]
        assert shard_valid_lengths(10, 4, 8, 3).tolist() == [10, 2, 0, 0]

    def test_shard_past_int32_refused(self, mesh8):
        from pfac_tpu import PfacError

        sm = ShardedMatcher(Automaton.from_patterns([b"ab"]), mesh=mesh8)
        with pytest.raises(PfacError):
            sm._shard_len(8 * (1 << 31))


class TestShardedDeviceReduce:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_reduce_matches_golden(self, mesh8, engine):
        # device-side per-shard compaction: ids/pos must equal the golden
        # reduce, including matches that straddle shard boundaries
        rng = np.random.default_rng(21)
        pats = [b"wxyz!", b"wx", b"q", b"wxyzab"]
        a = Automaton.from_patterns(pats)
        sm = _sharded(a, mesh8, engine, tile=256)
        n = 5000
        data = bytearray(rng.integers(97, 123, size=n, dtype=np.uint8).tobytes())
        shard = sm._shard_len(n)
        for b in range(shard - 3, n - 8, shard):   # straddle boundaries
            data[b:b + 6] = b"wxyzab"
        data = bytes(data)
        ids, pos, count = sm.match_reduce(data)
        g_ids, g_pos, g_count = golden.reduce_result(golden.match_dense(a, data))
        assert count == g_count
        assert pos.tolist() == g_pos.tolist()
        assert ids.tolist() == g_ids.tolist()
        assert pos.dtype == np.int64

    @pytest.mark.parametrize("engine", ENGINES)
    def test_reduce_cap_overflow_falls_back(self, mesh8, engine):
        a = Automaton.from_patterns([b"ab"])
        sm = _sharded(a, mesh8, engine, tile=128, reduce_cap=4)
        data = b"ab" * 400                      # >4 matches per shard
        ids, pos, count = sm.match_reduce(data)
        g_ids, g_pos, g_count = golden.reduce_result(golden.match_dense(a, data))
        assert (count, pos.tolist(), ids.tolist()) == (
            g_count, g_pos.tolist(), g_ids.tolist())

    def test_reduce_no_matches(self, mesh8):
        a = Automaton.from_patterns([b"zz"])
        ids, pos, count = ShardedMatcher(a, mesh=mesh8, tile=64).match_reduce(
            b"ab" * 300)
        assert count == 0 and ids.size == 0 and pos.dtype == np.int64
