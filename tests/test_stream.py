"""StreamMatcher: exact chunked matching equals whole-corpus matching."""
import numpy as np
import pytest

from pfac_tpu import Automaton, Matcher
from pfac_tpu.backends import golden


def _stream_all(m, data, chunks, min_batch):
    sm = m.stream(min_batch=min_batch)
    parts = []
    off = 0
    for c in chunks:
        start, ids = sm.feed(c)
        if ids.shape[0]:
            assert start == off
            off += ids.shape[0]
            parts.append(ids)
    start, ids = sm.finish()
    assert start == off
    parts.append(ids)
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


class TestStreamMatcher:
    @pytest.mark.parametrize("chunk_size", [1, 7, 100, 4096])
    def test_equals_whole_corpus(self, chunk_size):
        rng = np.random.default_rng(chunk_size)
        pats = [b"ab", b"abc", b"bca", b"aaaa", b"c"]
        a = Automaton.from_patterns(pats)
        m = Matcher(automaton=a, platform="cpu")
        data = bytes(rng.integers(97, 100, size=5000).astype(np.uint8))
        chunks = [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]
        got = _stream_all(m, data, chunks, min_batch=256)
        exp = golden.match_dense(a, data)
        assert np.array_equal(got, exp)

    @pytest.mark.parametrize("perf_mode", ["dense", "hash"])
    def test_over_the_gpu_kernel(self, perf_mode):
        # uneven chunks through the GPU walk kernel (interpreted here)
        from pfac_tpu import StreamMatcher
        from pfac_tpu.backends.gpu_walk import GpuWalkMatcher

        rng = np.random.default_rng(9)
        a = Automaton.from_patterns([b"ab", b"abcab", b"cc", b"bcabca"])
        eng = GpuWalkMatcher(a, perf_mode=perf_mode, interpret=True)
        data = bytes(rng.integers(97, 100, size=3000).astype(np.uint8))
        cuts = [0, 1, 700, 701, 1900, 3000]
        sm = StreamMatcher(eng, min_batch=256)
        got = np.zeros(len(data), np.int32)
        for lo, hi in zip(cuts, cuts[1:]):
            start, ids = sm.feed(data[lo:hi])
            got[start:start + ids.shape[0]] = ids
        start, ids = sm.finish()
        got[start:start + ids.shape[0]] = ids
        assert start + ids.shape[0] == len(data)
        assert np.array_equal(got, golden.match_dense_batch(a, data))

    def test_match_straddles_every_boundary(self):
        pats = [b"HELLOWORLD"]
        a = Automaton.from_patterns(pats)
        m = Matcher(automaton=a, platform="cpu")
        data = (b"..HELLOWORLD.." * 50)
        chunks = [data[i:i + 13] for i in range(0, len(data), 13)]
        got = _stream_all(m, data, chunks, min_batch=1)
        assert np.array_equal(got, golden.match_dense(a, data))

    def test_tiny_feeds_buffered(self):
        a = Automaton.from_patterns([b"xyz"])
        m = Matcher(automaton=a, platform="cpu")
        sm = m.stream(min_batch=1 << 20)
        for b in (b"x", b"y", b"z", b"x"):
            start, ids = sm.feed(b)
            assert ids.shape[0] == 0       # below min_batch: buffered
        start, ids = sm.finish()
        assert start == 0 and ids.tolist() == [1, 0, 0, 0]

    def test_finish_twice_rejected(self):
        from pfac_tpu.status import PfacError

        m = Matcher([b"a"], platform="cpu")
        sm = m.stream()
        sm.finish()
        with pytest.raises(PfacError):
            sm.finish()


class TestAutoChunking:
    def test_match_routes_big_inputs_through_stream(self, monkeypatch):
        # shrink the limit + feed step so the chunked path runs at test
        # scale; the result must equal the direct engine byte-for-byte
        from pfac_tpu import Matcher

        m = Matcher([b"wxyz!", b"wx", b"q"])
        rng = np.random.default_rng(7)
        data = bytearray(rng.integers(97, 123, size=9000, dtype=np.uint8).tobytes())
        for off in range(500, 8500, 700):       # incl. chunk-boundary straddles
            data[off:off + 5] = b"wxyz!"
        data = bytes(data)
        direct = m.match(data)
        monkeypatch.setattr(Matcher, "_CHUNK_LIMIT", 4096)
        monkeypatch.setattr(Matcher, "_chunk_step", 1500)
        routed = m.match(data)                  # > limit -> chunked path
        assert routed.tolist() == direct.tolist()
