"""Matcher: the framework's runtime handle.

Equivalent of the reference's `PFAC_context` handle + dispatch layer
(reference: PFAC/src/PFAC.cpp:133-204,741-833,843-961): owns the compiled
automaton, the mode configuration, and the device-resident tables; routes
match calls to the selected backend.

Mode mapping from the reference:

* `PFAC_setPlatform(GPU/CPU/CPU_OMP)`  ->  Platform.DEVICE / CPU / CPU_PARALLEL
  (DEVICE = the accelerator JAX default backend; CPU = serial NumPy golden
  model; CPU_PARALLEL = the XLA walker jit-compiled for the host CPU, the
  analog of the OpenMP backend.)
* `PFAC_setPerfMode(TIME/SPACE_DRIVEN)` ->  PerfMode.DENSE / HASH
* `PFAC_setTextureMode(AUTO/ON/OFF)`    ->  PlacementMode.AUTO / VMEM / HBM
  (accepted and validated for API parity; the engine is chosen from the
  platform alone, see `_build_engine`.)
"""
from __future__ import annotations

import enum
from typing import Sequence

import numpy as np

from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus
from . import _lazy


class Platform(enum.IntEnum):
    DEVICE = 0        # reference: PFAC_PLATFORM_GPU (default)
    CPU = 1           # reference: PFAC_PLATFORM_CPU (serial golden model)
    CPU_PARALLEL = 2  # reference: PFAC_PLATFORM_CPU_OMP


class PerfMode(enum.IntEnum):
    DENSE = 0  # reference: PFAC_TIME_DRIVEN (default)
    HASH = 1   # reference: PFAC_SPACE_DRIVEN


class PlacementMode(enum.IntEnum):
    """The reference's texture mode. Kept for API parity; no engine reads it."""

    AUTO = 0  # reference: PFAC_AUTOMATIC (default)
    VMEM = 1  # reference: PFAC_TEXTURE_ON
    HBM = 2   # reference: PFAC_TEXTURE_OFF


class Backend(enum.Enum):
    """GOLDEN runs the host oracle; every other value means the device
    engine for the platform (XLA and PALLAS are kept as accepted names)."""

    AUTO = "auto"
    XLA = "xla"
    PALLAS = "pallas"
    GOLDEN = "golden"


class Matcher:
    """Compile patterns once, match many inputs.

    >>> m = Matcher([b"AB", b"ABG", b"BEDE", b"ED"])
    >>> m.match(b"ABEDEDABG")[:7].tolist()
    [1, 3, 4, 0, 4, 0, 2]
    """

    def __init__(
        self,
        patterns: Sequence[bytes] | None = None,
        *,
        pattern_file: str | None = None,
        automaton: Automaton | None = None,
        perf_mode: PerfMode | str = PerfMode.DENSE,
        platform: Platform | str = Platform.DEVICE,
        placement: PlacementMode | str = PlacementMode.AUTO,
        backend: Backend | str = Backend.AUTO,
        tile: int | None = None,
        device=None,
    ):
        nsrc = sum(x is not None for x in (patterns, pattern_file, automaton))
        if nsrc != 1:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                "exactly one of patterns / pattern_file / automaton required",
            )
        if automaton is not None:
            self.automaton = automaton
        elif pattern_file is not None:
            self.automaton = Automaton.from_pattern_file(pattern_file)
        else:
            self.automaton = Automaton.from_patterns(patterns)

        self.perf_mode = _coerce(PerfMode, perf_mode)
        self.platform = _coerce(Platform, platform)
        self.placement = _coerce(PlacementMode, placement)
        self.backend = Backend(backend) if not isinstance(backend, Backend) else backend
        self.tile = tile
        self.device = device
        self._engines: dict = {}

    # ------------------------------------------------------------- config
    def set_perf_mode(self, perf_mode: PerfMode | str) -> None:
        """Reference: PFAC_setPerfMode rebuilds the table on change
        (PFAC/src/PFAC.cpp:782-817); here tables are built lazily per mode
        and cached, so switching is free."""
        self.perf_mode = _coerce(PerfMode, perf_mode)

    def set_platform(self, platform: Platform | str) -> None:
        self.platform = _coerce(Platform, platform)

    def set_placement(self, placement: PlacementMode | str) -> None:
        self.placement = _coerce(PlacementMode, placement)

    # -------------------------------------------------------------- match
    #: device engines address positions as int32; larger inputs stream.
    #: Equals gpu_walk.MAX_INPUT_BYTES (the margin under 2**31 covers the
    #: kernel's reads past the last position).
    _CHUNK_LIMIT = (1 << 31) - (1 << 22)

    def match(self, data) -> np.ndarray:
        """`PFAC_matchFromHost` analog: bytes in, int32[N] of pattern IDs out
        (result[i] = longest pattern starting at byte i, 0 if none).

        Inputs beyond the device engines' int32 position range (~2 GiB)
        are routed through StreamMatcher automatically — exact results,
        one carry of max_pattern_len-1 bytes between chunks."""
        n = _len_of(data)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        if self.platform == Platform.CPU:
            from ..backends import golden
            mode = "dense" if self.perf_mode == PerfMode.DENSE else "hash"
            return golden.match(self.automaton, data, mode)
        if n > self._CHUNK_LIMIT:
            return self._match_chunked(data, n)
        return self._engine().match(data)

    _chunk_step = 1 << 30     # feed size for the auto-chunked path

    def _match_chunked(self, data, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        step = self._chunk_step
        sm = self.stream(min_batch=min(1 << 20, step))
        for off in range(0, n, step):
            start, ids = sm.feed(data[off: off + step])
            out[start: start + ids.shape[0]] = ids
        start, ids = sm.finish()
        out[start: start + ids.shape[0]] = ids
        return out

    def match_device(self, data_u8):
        """`PFAC_matchFromDevice` analog: device uint8 array in, device
        int32 array (padded to tile multiple) out."""
        return self._engine().match_device(data_u8)

    def match_reduce(self, data) -> tuple[np.ndarray, np.ndarray, int]:
        """`PFAC_matchFromHostReduce` analog: (ids, positions, count)."""
        if _len_of(data) == 0:
            z = np.zeros(0, dtype=np.int32)
            return z, z, 0
        if self.platform == Platform.CPU:
            from ..backends import golden
            mode = "dense" if self.perf_mode == PerfMode.DENSE else "hash"
            return golden.reduce_result(golden.match(self.automaton, data, mode))
        return self._engine().match_reduce(data)

    def match_reduce_device(self, data_u8):
        return self._engine().match_reduce_device(data_u8)

    def stream(self, *, min_batch: int = 1 << 20):
        """A StreamMatcher over this handle: exact chunked matching with
        carry-over across chunk boundaries (see runtime/stream.py)."""
        from .stream import StreamMatcher
        return StreamMatcher(self, min_batch=min_batch)

    # --------------------------------------------------------- introspect
    def dump_transition_table(self, fp=None) -> str:
        return self.automaton.dump_transition_table(fp)

    def memory_usage(self) -> str:
        mode = "dense" if self.perf_mode == PerfMode.DENSE else "hash"
        return self.automaton.memory_usage(mode)

    # ------------------------------------------------------------ engines
    def _engine(self):
        key = (self.platform, self.perf_mode, self.backend == Backend.GOLDEN)
        eng = self._engines.get(key)
        if eng is None:
            eng = self._build_engine()
            self._engines[key] = eng
        return eng

    def _build_engine(self):
        mode = "dense" if self.perf_mode == PerfMode.DENSE else "hash"
        device = self.device
        if self.platform == Platform.CPU_PARALLEL:
            device = _lazy.cpu_device()
        backend = self.backend
        if backend == Backend.GOLDEN:
            from ..backends import golden

            class _GoldenEngine:
                def __init__(self, automaton, mode):
                    self.automaton, self.mode = automaton, mode

                def match(self, data):
                    return golden.match(self.automaton, data, self.mode)

                def match_reduce(self, data):
                    return golden.reduce_result(self.match(data))

                def match_device(self, data_u8):
                    raise PfacError(PfacStatus.INVALID_PARAMETER,
                                    "golden backend has no device path")

                match_reduce_device = match_device

            return _GoldenEngine(self.automaton, mode)

        if _device_platform(device) == "gpu":
            from ..backends.gpu_walk import GpuWalkMatcher
            return GpuWalkMatcher(self.automaton, perf_mode=mode, device=device)

        from ..backends.xla import DEFAULT_TILE, XlaMatcher
        return XlaMatcher(
            self.automaton, perf_mode=mode,
            tile=self.tile or DEFAULT_TILE, device=device,
        )


def _device_platform(device) -> str:
    """Platform of the device an engine will run on (JAX's default
    backend when no device is given)."""
    if device is not None:
        return device.platform
    import jax

    return jax.default_backend()


def _coerce(enum_cls, v):
    if isinstance(v, enum_cls):
        return v
    if isinstance(v, str):
        key = v.upper()
        aliases = {
            "TIME_DRIVEN": "DENSE", "SPACE_DRIVEN": "HASH",
            "GPU": "DEVICE", "TPU": "DEVICE", "CPU_OMP": "CPU_PARALLEL",
            "TEXTURE_ON": "VMEM", "TEXTURE_OFF": "HBM", "AUTOMATIC": "AUTO",
        }
        key = aliases.get(key, key)
        try:
            return enum_cls[key]
        except KeyError:
            pass
    try:
        return enum_cls(v)
    except ValueError:
        raise PfacError(PfacStatus.INVALID_PARAMETER, f"bad {enum_cls.__name__}: {v!r}")


def _len_of(data) -> int:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return len(data)
    return int(np.asarray(data).shape[0])
