"""Pythonic Matcher API + C-style capi parity layer."""
import numpy as np
import pytest

from pfac_tpu import Matcher, PerfMode, PfacStatus, Platform, get_error_string
from pfac_tpu.runtime import capi


class TestMatcher:
    def test_basic(self):
        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], tile=64)
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    def test_platform_cpu_golden(self):
        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], platform="cpu")
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    def test_platform_cpu_parallel(self):
        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], platform="cpu_omp", tile=64)
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    def test_perf_mode_switch(self):
        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], tile=64)
        dense = m.match(b"ABEDEDABG")
        m.set_perf_mode("hash")
        hashed = m.match(b"ABEDEDABG")
        assert dense.tolist() == hashed.tolist()

    def test_match_reduce(self):
        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], tile=64)
        ids, pos, n = m.match_reduce(b"ABEDEDABG")
        assert (n, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2])

    def test_str_patterns(self):
        m = Matcher(["ab", "cd"], tile=32)
        assert m.match(b"abcd").tolist() == [1, 0, 2, 0]

    def test_empty_input(self):
        m = Matcher([b"x"], tile=32)
        assert m.match(b"").tolist() == []
        ids, pos, n = m.match_reduce(b"")
        assert n == 0

    def test_doc_dump(self):
        m = Matcher([b"AB"], tile=32)
        assert "Transition table" in m.dump_transition_table()
        assert "time-driven" in m.memory_usage()


class TestCapi:
    def test_full_flow(self, example_pattern_path, example_input):
        handle = []
        assert capi.PFAC_create(handle) == PfacStatus.SUCCESS
        h = handle[0]
        assert capi.PFAC_setPlatform(h, capi.PFAC_PLATFORM_GPU) == PfacStatus.SUCCESS
        assert capi.PFAC_setPerfMode(h, capi.PFAC_TIME_DRIVEN) == PfacStatus.SUCCESS
        assert capi.PFAC_readPatternFromFile(h, example_pattern_path) == PfacStatus.SUCCESS
        n = len(example_input)
        result = np.zeros(n, dtype=np.int32)
        assert capi.PFAC_matchFromHost(h, example_input, n, result) == PfacStatus.SUCCESS
        assert result.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0, 0]
        assert capi.PFAC_destroy(h) == PfacStatus.SUCCESS

    def test_reduce_flow(self, example_pattern_path, example_input):
        handle = []
        capi.PFAC_create(handle)
        h = handle[0]
        capi.PFAC_setPerfMode(h, capi.PFAC_SPACE_DRIVEN)
        capi.PFAC_readPatternFromFile(h, example_pattern_path)
        n = len(example_input)
        ids = np.zeros(n, dtype=np.int32)
        pos = np.zeros(n, dtype=np.int32)
        cnt = []
        st = capi.PFAC_matchFromHostReduce(h, example_input, n, ids, pos, cnt)
        assert st == PfacStatus.SUCCESS
        assert cnt[0] == 5
        assert pos[:5].tolist() == [0, 1, 2, 4, 6]
        assert ids[:5].tolist() == [1, 3, 4, 4, 2]

    def test_error_paths(self):
        assert capi.PFAC_destroy(None) == PfacStatus.INVALID_HANDLE
        assert capi.PFAC_setPlatform(None, 0) == PfacStatus.INVALID_HANDLE
        handle = []
        capi.PFAC_create(handle)
        h = handle[0]
        assert capi.PFAC_setPlatform(h, 99) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_setPerfMode(h, 99) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_readPatternFromFile(h, "/nonexistent") == PfacStatus.FILE_OPEN_ERROR
        r = np.zeros(4, dtype=np.int32)
        assert capi.PFAC_matchFromHost(h, b"abcd", 4, r) == PfacStatus.PATTERNS_NOT_READY

    def test_error_strings(self):
        assert "successful" in get_error_string(PfacStatus.SUCCESS)
        assert "PFAC_readPatternFromFile" in get_error_string(PfacStatus.PATTERNS_NOT_READY)
        assert capi.PFAC_getErrorString(PfacStatus.INVALID_HANDLE).startswith(
            "PFAC_STATUS_INVALID_HANDLE"
        )

    def test_dump_and_memory(self, example_pattern_path, tmp_path, capsys):
        handle = []
        capi.PFAC_create(handle)
        h = handle[0]
        capi.PFAC_readPatternFromFile(h, example_pattern_path)
        with open(tmp_path / "table.txt", "w") as f:
            assert capi.PFAC_dumpTransitionTable(h, f) == PfacStatus.SUCCESS
        text = (tmp_path / "table.txt").read_text()
        assert "number of states = 11" in text
        assert capi.PFAC_memoryUsage(h) == PfacStatus.SUCCESS
        assert "time-driven" in capsys.readouterr().out


class TestConcurrentHandles:
    """Reference T5 parity (PFAC/test/SimpleMultiGPU_pthread.cpp): multiple
    independent handles driven from concurrent host threads. No global
    state — the reference needed a texture-bind mutex (its C18); we must
    need nothing."""

    def test_two_threads_independent_matchers(self):
        import threading

        import numpy as np

        from pfac_tpu import Matcher

        results = {}
        errors = []

        def work(name, pats, data, expected):
            try:
                m = Matcher(pats, platform="cpu_parallel", tile=64)
                for _ in range(3):
                    results[name] = m.match(data).tolist()
                    assert results[name] == expected
            except Exception as e:  # pragma: no cover
                errors.append((name, e))

        t1 = threading.Thread(target=work, args=(
            "a", [b"AB", b"ABG", b"BEDE", b"ED"], b"ABEDEDABG",
            [1, 3, 4, 0, 4, 0, 2, 0, 0]))
        t2 = threading.Thread(target=work, args=(
            "b", [b"s", b"h", b"he", b"she", b"hers", b"her", b"his", b"iis", b"is", b"ii"],
            b"sheshershisiis", None))
        # compute thread-b's expectation single-threaded first
        from pfac_tpu.backends import golden
        from pfac_tpu import Automaton
        exp_b = golden.match_dense(
            Automaton.from_patterns(
                [b"s", b"h", b"he", b"she", b"hers", b"her", b"his", b"iis", b"is", b"ii"]),
            b"sheshershisiis").tolist()
        t2 = threading.Thread(target=work, args=(
            "b", [b"s", b"h", b"he", b"she", b"hers", b"her", b"his", b"iis", b"is", b"ii"],
            b"sheshershisiis", exp_b))
        t1.start(); t2.start()
        t1.join(); t2.join()
        assert not errors, errors
        assert results["a"] == [1, 3, 4, 0, 4, 0, 2, 0, 0]
        assert results["b"] == exp_b


class TestPlacementModes:
    def test_hbm_placement_forces_xla(self):
        from pfac_tpu import Matcher
        from pfac_tpu.backends.xla import XlaMatcher

        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], placement="hbm", tile=64)
        assert isinstance(m._engine(), XlaMatcher)
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    @pytest.mark.parametrize("placement", ["auto", "vmem", "hbm",
                                           "texture_on", "texture_off"])
    def test_placement_accepted_same_engine(self, placement):
        from pfac_tpu import Matcher

        m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], placement=placement,
                    tile=64)
        default = Matcher([b"AB", b"ABG", b"BEDE", b"ED"], tile=64)
        assert type(m._engine()) is type(default._engine())
        assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    def test_set_texture_mode_status_codes(self, example_pattern_path):
        h = []
        capi.PFAC_create(h)
        for mode in (capi.PFAC_AUTOMATIC, capi.PFAC_TEXTURE_ON,
                     capi.PFAC_TEXTURE_OFF):
            assert capi.PFAC_setTextureMode(h[0], mode) == PfacStatus.SUCCESS
        assert capi.PFAC_setTextureMode(h[0], 7) == PfacStatus.INVALID_PARAMETER
        assert capi.PFAC_setTextureMode(None, 0) == PfacStatus.INVALID_HANDLE
        assert capi.PFAC_readPatternFromFile(h[0], example_pattern_path) \
            == PfacStatus.SUCCESS
        r = np.zeros(9, np.int32)
        assert capi.PFAC_matchFromHost(h[0], b"ABEDEDABG", 9, r) \
            == PfacStatus.SUCCESS
        assert r.tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


class TestDeviceApis:
    def test_match_from_device_capi(self):
        import jax
        import numpy as np

        from pfac_tpu.runtime import capi
        from pfac_tpu.status import PfacStatus

        h = [None]
        assert capi.PFAC_create(h) == PfacStatus.SUCCESS
        import os
        pat = os.path.join(os.path.dirname(__file__), "pattern", "example_pattern")
        assert capi.PFAC_readPatternFromFile(h[0], pat) == PfacStatus.SUCCESS
        d_input = jax.device_put(np.frombuffer(b"ABEDEDABG", dtype=np.uint8))
        d_out = []
        st = capi.PFAC_matchFromDevice(h[0], d_input, 9, d_out)
        assert st == PfacStatus.SUCCESS
        assert np.asarray(d_out[0])[:9].tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]

    def test_match_from_device_reduce_capi(self):
        import jax
        import numpy as np

        from pfac_tpu.runtime import capi
        from pfac_tpu.status import PfacStatus

        h = [None]
        assert capi.PFAC_create(h) == PfacStatus.SUCCESS
        import os
        pat = os.path.join(os.path.dirname(__file__), "pattern", "example_pattern")
        assert capi.PFAC_readPatternFromFile(h[0], pat) == PfacStatus.SUCCESS
        d_input = jax.device_put(np.frombuffer(b"ABEDEDABG", dtype=np.uint8))
        d_ids, d_pos, h_num = [], [], []
        st = capi.PFAC_matchFromDeviceReduce(h[0], d_input, 9, d_ids, d_pos, h_num)
        assert st == PfacStatus.SUCCESS
        c = h_num[0]
        assert c == 5
        assert np.asarray(d_pos[0])[:c].tolist() == [0, 1, 2, 4, 6]
        assert np.asarray(d_ids[0])[:c].tolist() == [1, 3, 4, 4, 2]
