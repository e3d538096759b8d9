"""Differential tests: native C++ host compiler vs the Python oracle."""
import numpy as np
import pytest

from pfac_tpu.core import native
from pfac_tpu.core.automaton import Automaton
from pfac_tpu.core.parser import parse_pattern_bytes
from pfac_tpu.core.trie import build_trie

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native toolchain unavailable"
)


def _python_automaton(data: bytes) -> Automaton:
    return Automaton.from_parsed(parse_pattern_bytes(data))


class TestNativeCompile:
    @pytest.mark.parametrize(
        "data",
        [
            b"AB\nABG\nBEDE\nED\n",
            b"s\nh\nhe\nshe\nhers\nher\nhis\niis\nis\nii\n",
            b"AB\n\n\nED\n",            # empty lines
            b"AB\nCD",                  # trailing unterminated line ignored
            b"dup\ndup\nduplic\n",      # duplicates
            b"\x00\x01\n\xff\xfe\n",    # binary
        ],
    )
    def test_matches_python(self, data):
        py = _python_automaton(data)
        nat = Automaton._from_native(data)
        assert nat is not None
        assert nat.num_states == py.num_states
        assert nat.initial_state == py.initial_state
        assert nat.num_leaves == py.num_leaves
        assert nat.pattern_ids.tolist() == py.pattern_ids.tolist()
        assert nat.pattern_lens.tolist() == py.pattern_lens.tolist()
        assert nat.sorted_patterns == py.sorted_patterns
        assert nat.trie.rows == py.trie.rows
        assert np.array_equal(nat.ensure_dense().table, py.ensure_dense().table)

    @pytest.mark.parametrize("seed", range(4))
    def test_random_rulesets(self, seed):
        rng = np.random.default_rng(seed)
        lines = []
        for _ in range(int(rng.integers(1, 200))):
            ln = int(rng.integers(1, 15))
            # avoid 0x0A inside patterns (file format can't express it)
            pat = bytes(x if x != 0x0A else 0x0B
                        for x in rng.integers(0, 256, size=ln).astype(np.uint8))
            lines.append(pat)
        data = b"\n".join(lines) + b"\n"
        py = _python_automaton(data)
        nat = Automaton._from_native(data)
        assert nat.trie.rows == py.trie.rows
        assert nat.sorted_patterns == py.sorted_patterns

    def test_dump_identical(self):
        data = b"AB\nABG\nBEDE\nED\n"
        assert (Automaton._from_native(data).dump_transition_table()
                == _python_automaton(data).dump_transition_table())

