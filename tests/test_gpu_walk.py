"""GPU walk kernel: interpret-mode parity with the golden model, and the
wrapper around it (padding, masking, engine choice, the int32 guard).

The kernel itself compiles only for the card; here it runs in Pallas
interpret mode. Tests marked ``gpu`` run the compiled kernel and skip
without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfac_tpu import Automaton, Matcher, PfacError, PfacStatus
from pfac_tpu.backends import golden
from pfac_tpu.backends import gpu_walk
from pfac_tpu.backends.gpu_walk import GpuWalkMatcher
from pfac_tpu.backends.xla import XlaMatcher
from pfac_tpu.runtime import handle

README = [b"AB", b"ABG", b"BEDE", b"ED"]


def _random_small():
    rng = np.random.default_rng(11)
    return [bytes(rng.integers(97, 101, size=int(rng.integers(1, 9)))
                  .astype(np.uint8)) for _ in range(20)]


def _depth64():
    rng = np.random.default_rng(12)
    deep = bytes(rng.integers(97, 100, size=64).astype(np.uint8))
    return [deep, deep[:40], deep[:3], deep[10:30]]


RULESETS = {
    "readme": README,
    "random_small": _random_small(),
    "depth64": _depth64(),
    "single_byte": [b"x", b"y", b"\x00"],
    "duplicates": [b"dup", b"dup", b"duplic", b"du"],
    "binary": [b"\x00\x01", b"\xff\xfe\xfd", b"\x00\xff\x00\xff", b"\x80"],
}


def _alphabet(pats):
    return np.frombuffer(b"".join(pats), np.uint8)


def _corpus(kind: str, pats) -> bytes:
    rng = np.random.default_rng(len(kind))
    alpha = _alphabet(pats)
    if kind == "one_byte":
        return pats[0][:1]
    if kind == "all_match":
        # patterns end to end: every lane walks, block after block
        out = b""
        while len(out) < 1024:
            out += pats[int(rng.integers(0, len(pats)))]
        return out[:1024]
    n = {"random": 1000, "planted": 1500, "odd_len": 257}[kind]
    data = bytearray(alpha[rng.integers(0, alpha.size, size=n)].tobytes())
    if kind == "planted":
        for _ in range(40):
            p = pats[int(rng.integers(0, len(pats)))]
            off = int(rng.integers(0, n - len(p) + 1))
            data[off:off + len(p)] = p
    if kind == "odd_len":
        p = max(pats, key=len)[: n]
        data[n - len(p):] = p              # a match that ends at the end
    return bytes(data)


@pytest.mark.parametrize("corpus", ["random", "planted", "all_match",
                                    "odd_len", "one_byte"])
@pytest.mark.parametrize("ruleset", sorted(RULESETS))
@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_kernel_matches_golden(mode, ruleset, corpus):
    pats = RULESETS[ruleset]
    a = Automaton.from_patterns(pats)
    data = _corpus(corpus, pats)
    m = GpuWalkMatcher(a, perf_mode=mode, interpret=True)
    expected = golden.match_dense_batch(a, data)
    assert m.match(data).tolist() == expected.tolist()


@pytest.mark.parametrize("block", [256, 512, 1024])
def test_block_padding(block):
    a = Automaton.from_patterns(README)
    m = GpuWalkMatcher(a, interpret=True)
    data = b"ABEDEDABG" * 40
    n = len(data)
    d = jnp.asarray(np.frombuffer(data, np.uint8))
    out = np.asarray(gpu_walk.walk(
        m.tables, m._pair_state, m._pair_match, d,
        jnp.full((1,), n, jnp.int32), num_out=gpu_walk.padded_len(n, block),
        block=block, **m.walk_kwargs()))
    assert out.shape[0] % block == 0 and out.shape[0] - n < block
    assert out[:n].tolist() == golden.match_dense(a, data).tolist()
    assert not out[n:].any()


def test_match_device_pads_to_the_default_block():
    m = GpuWalkMatcher(Automaton.from_patterns(README), interpret=True)
    out = m.match_device(jnp.asarray(np.frombuffer(b"ABEDEDABG", np.uint8)))
    assert out.shape == (gpu_walk.DEFAULT_BLOCK,)


@pytest.mark.parametrize("n_valid", [1, 9, 200, 511])
def test_reads_past_n_are_end_of_input(n_valid):
    # bytes past n_valid must not complete a match (they stand for the
    # end of input), and positions past it report 0
    a = Automaton.from_patterns([b"ABG", b"BG", b"G"])
    data = np.frombuffer(b"ABG" * 200, np.uint8)
    m = GpuWalkMatcher(a, interpret=True)
    out = gpu_walk.walk(
        m.tables, m._pair_state, m._pair_match, jnp.asarray(data),
        jnp.full((1,), n_valid, jnp.int32), num_out=512, **m.walk_kwargs())
    expected = golden.match_dense(a, data[:n_valid].tobytes())
    assert np.asarray(out)[:n_valid].tolist() == expected.tolist()
    assert not np.asarray(out)[n_valid:].any()


def test_num_out_must_be_block_multiple():
    m = GpuWalkMatcher(Automaton.from_patterns(README), interpret=True)
    with pytest.raises(ValueError, match="multiple"):
        gpu_walk.walk(m.tables, m._pair_state, m._pair_match,
                      jnp.zeros(10, jnp.uint8), jnp.full((1,), 10, jnp.int32),
                      num_out=gpu_walk.DEFAULT_BLOCK + 1, **m.walk_kwargs())


@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_match_device_and_reduce(mode):
    a = Automaton.from_patterns(README)
    m = GpuWalkMatcher(a, perf_mode=mode, interpret=True)
    d = jnp.asarray(np.frombuffer(b"ABEDEDABG", np.uint8))
    ids, pos, count = m.match_reduce_device(d)
    c = int(count)
    assert (c, np.asarray(pos)[:c].tolist(), np.asarray(ids)[:c].tolist()) \
        == (5, [0, 1, 2, 4, 6], [1, 3, 4, 4, 2])
    ids, pos, count = m.match_reduce(b"ABEDEDABG")
    assert (count, pos.tolist(), ids.tolist()) == (5, [0, 1, 2, 4, 6],
                                                   [1, 3, 4, 4, 2])
    assert m.match(b"").tolist() == []


def test_engine_on_a_non_default_device():
    dev = jax.devices()[-1]
    m = GpuWalkMatcher(Automaton.from_patterns(README), interpret=True,
                       device=dev)
    assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


# ---------------------------------------------------------------- guard
def test_dense_index_limit_is_the_int32_edge():
    top = gpu_walk.MAX_DENSE_STATES
    assert (top - 1) * 257 + 256 <= 2**31 - 1
    assert top * 257 + 256 > 2**31 - 1


@pytest.mark.parametrize("states,ok", [(8_355_967, True), (8_355_968, False),
                                       (6_000_000, True)])
def test_dense_index_guard(states, ok):
    if ok:
        gpu_walk.check_dense_index(states)
    else:
        with pytest.raises(PfacError) as e:
            gpu_walk.check_dense_index(states)
        assert e.value.status == PfacStatus.INVALID_PARAMETER
        assert "hash" in str(e.value)


def test_input_past_int32_positions_refused():
    m = GpuWalkMatcher(Automaton.from_patterns(README), interpret=True)
    big = jax.ShapeDtypeStruct((gpu_walk.MAX_INPUT_BYTES + 1,), jnp.uint8)
    with pytest.raises(PfacError):
        m.match_device(big)
    from pfac_tpu.runtime.handle import Matcher as M
    assert M._CHUNK_LIMIT == gpu_walk.MAX_INPUT_BYTES


def test_dense_engine_refuses_wrapping_table(monkeypatch):
    a = Automaton.from_patterns(README)
    monkeypatch.setattr(a, "num_states", gpu_walk.MAX_DENSE_STATES + 1)
    with pytest.raises(PfacError):
        GpuWalkMatcher(a, perf_mode="dense", interpret=True)


# --------------------------------------------------------- engine choice
@pytest.mark.parametrize("platform,engine", [("gpu", GpuWalkMatcher),
                                             ("cpu", XlaMatcher)])
def test_engine_chosen_by_platform(monkeypatch, platform, engine):
    monkeypatch.setattr(handle, "_device_platform", lambda device: platform)
    m = Matcher(README)
    eng = m._engine()
    assert type(eng) is engine
    assert not getattr(eng, "interpret", False)   # compiled, never interpreted


@pytest.mark.parametrize("kw", [{"backend": "pallas"}, {"backend": "xla"},
                                {"placement": "vmem"}, {"placement": "hbm"},
                                {"placement": "texture_on"}])
def test_options_do_not_change_the_gpu_engine(monkeypatch, kw):
    monkeypatch.setattr(handle, "_device_platform", lambda device: "gpu")
    eng = Matcher(README, **kw)._engine()
    assert type(eng) is GpuWalkMatcher and not eng.interpret


def test_cpu_parallel_uses_the_xla_walker():
    m = Matcher(README, platform="cpu_parallel", tile=64)
    assert type(m._engine()) is XlaMatcher
    assert m.match(b"ABEDEDABG").tolist() == [1, 3, 4, 0, 4, 0, 2, 0, 0]


def test_device_platform_reads_the_device():
    assert handle._device_platform(jax.devices("cpu")[0]) == "cpu"
    assert handle._device_platform(None) == jax.default_backend()


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dense", "hash"])
def test_compiled_kernel_matches_golden(gpu_device, mode):
    from pfac_tpu.tools import workloads

    pats = workloads.snort_like_patterns()
    a = Automaton.from_patterns(pats)
    rng = np.random.default_rng(0)
    data = workloads.planted_text(rng, pats, 1 << 20, share=0.05)
    m = Matcher(automaton=a, perf_mode=mode)
    assert type(m._engine()) is GpuWalkMatcher
    assert np.array_equal(m.match(data), golden.match_dense_batch(a, data))
