"""XLA backend: parity with the golden model, both perf modes, reduce path."""
import numpy as np
import pytest

from pfac_tpu import Automaton
from pfac_tpu.backends import golden
from pfac_tpu.backends.xla import XlaMatcher


def _rand_case(seed, max_pat=10, max_len=8, n_lo=1, n_hi=400):
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, size=int(rng.integers(2, 6))).astype(np.uint8)
    k = int(rng.integers(1, max_pat + 1))
    pats = [
        bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(1, max_len)))])
        for _ in range(k)
    ]
    data = bytes(alpha[rng.integers(0, len(alpha), size=int(rng.integers(n_lo, n_hi)))])
    return pats, data


class TestXlaDense:
    def test_readme_example(self, example_pattern_path, example_input):
        a = Automaton.from_pattern_file(example_pattern_path)
        m = XlaMatcher(a, perf_mode="dense", tile=256)
        assert m.match(example_input).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]

    @pytest.mark.parametrize("seed", range(8))
    def test_random_vs_golden(self, seed):
        pats, data = _rand_case(seed)
        a = Automaton.from_patterns(pats)
        expected = golden.match_dense(a, data)
        got = XlaMatcher(a, perf_mode="dense", tile=128).match(data)
        assert got.tolist() == expected.tolist()

    def test_multi_tile_boundary(self):
        # matches that span tile boundaries must resolve via the padded reads
        pats = [b"abcd", b"bc"]
        data = b"xabcdx" * 50
        a = Automaton.from_patterns(pats)
        for tile in (8, 16, 64, 512):
            got = XlaMatcher(a, perf_mode="dense", tile=tile).match(data)
            assert got.tolist() == golden.match_dense(a, data).tolist(), tile

    def test_input_shorter_than_tile(self):
        a = Automaton.from_patterns([b"ab"])
        m = XlaMatcher(a, perf_mode="dense", tile=1024)
        assert m.match(b"ab").tolist() == [1, 0]
        assert m.match(b"a").tolist() == [0]
        assert m.match(b"").tolist() == []

    def test_single_byte_patterns(self):
        a = Automaton.from_patterns([b"x", b"y"])
        m = XlaMatcher(a, perf_mode="dense", tile=16)
        assert m.match(b"xyzzyx").tolist() == [1, 2, 0, 0, 2, 1]

    def test_long_walk_pattern(self):
        # pattern longer than one "pair step": exercises the while loop deeply
        pat = bytes(range(65, 91))  # A..Z, 26 bytes
        a = Automaton.from_patterns([pat])
        data = b"123" + pat + b"45" + pat[:10]
        m = XlaMatcher(a, perf_mode="dense", tile=32)
        expected = golden.match_dense(a, data)
        assert m.match(data).tolist() == expected.tolist()


class TestXlaHash:
    def test_readme_example(self, example_pattern_path, example_input):
        a = Automaton.from_pattern_file(example_pattern_path, hashed=True)
        m = XlaMatcher(a, perf_mode="hash", tile=256)
        assert m.match(example_input).tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]

    @pytest.mark.parametrize("seed", range(8))
    def test_random_vs_golden(self, seed):
        pats, data = _rand_case(seed)
        a = Automaton.from_patterns(pats, hashed=True)
        expected = golden.match_dense(a, data)
        got = XlaMatcher(a, perf_mode="hash", tile=128).match(data)
        assert got.tolist() == expected.tolist()


class TestXlaReduce:
    def test_readme_example(self, example_pattern_path, example_input):
        a = Automaton.from_pattern_file(example_pattern_path)
        m = XlaMatcher(a, perf_mode="dense", tile=256)
        ids, pos, n = m.match_reduce(example_input)
        assert n == 5
        assert pos.tolist() == [0, 1, 2, 4, 6]
        assert ids.tolist() == [1, 3, 4, 4, 2]

    @pytest.mark.parametrize("seed", range(4))
    def test_random_vs_golden(self, seed):
        pats, data = _rand_case(seed)
        a = Automaton.from_patterns(pats)
        g_ids, g_pos, g_n = golden.reduce_result(golden.match_dense(a, data))
        ids, pos, n = XlaMatcher(a, perf_mode="dense", tile=64).match_reduce(data)
        assert n == g_n
        assert pos.tolist() == g_pos.tolist()
        assert ids.tolist() == g_ids.tolist()

    def test_no_matches(self):
        a = Automaton.from_patterns([b"zz"])
        ids, pos, n = XlaMatcher(a, tile=32).match_reduce(b"aaaaaaa")
        assert n == 0 and ids.tolist() == [] and pos.tolist() == []

    def test_all_positions_match(self):
        a = Automaton.from_patterns([b"a"])
        ids, pos, n = XlaMatcher(a, tile=8).match_reduce(b"aaaa")
        assert n == 4 and pos.tolist() == [0, 1, 2, 3] and ids.tolist() == [1] * 4


class TestPrefix1d:
    """xla._prefix_1d must be exactly jnp.cumsum for flag-like inputs —
    it replaces the corpus-sized cumsum inside every reduce path."""

    @pytest.mark.parametrize(
        "n", [1, 127, 128, 129, 1 << 14, (1 << 14) + 1, (1 << 17) + 77])
    def test_matches_cumsum(self, n):
        import jax.numpy as jnp
        from pfac_tpu.backends.xla import _prefix_1d

        rng = np.random.default_rng(n)
        x = rng.integers(0, 2, size=n).astype(np.int32)
        got = np.asarray(_prefix_1d(jnp.asarray(x)))
        assert np.array_equal(got, np.cumsum(x))

    def test_row_sum_headroom(self):
        # f32 lane prefix is exact while each 128-lane row sum < 2^24;
        # callers pass per-row counts up to a few hundred — verify well
        # past flag range
        import jax.numpy as jnp
        from pfac_tpu.backends.xla import _prefix_1d

        x = np.full(1 << 15, 1000, np.int32)
        got = np.asarray(_prefix_1d(jnp.asarray(x)))
        assert np.array_equal(got, np.cumsum(x))
