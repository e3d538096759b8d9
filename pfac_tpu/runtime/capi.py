"""C-style API parity layer.

One-to-one equivalents of the 11 reference entry points
(reference: PFAC/include/PFAC.h:87-214) with the same handle/status-code
discipline: every function returns a PfacStatus, never raises, and writes
results through caller-provided buffers where the C API did.

This exists so code written against the C library maps line-for-line:

    handle = []                                  # PFAC_handle_t *
    PFAC_create(handle)                          # PFAC_create(&handle)
    PFAC_readPatternFromFile(handle[0], path)
    result = np.zeros(len(data), np.int32)
    PFAC_matchFromHost(handle[0], data, len(data), result)
"""
from __future__ import annotations

import sys
from typing import MutableSequence

import numpy as np

from ..core.automaton import Automaton
from ..status import PfacError, PfacStatus
from .handle import Matcher, PerfMode, Platform, PlacementMode

# enum value parity (reference: PFAC/include/PFAC.h:27-42)
PFAC_PLATFORM_GPU = Platform.DEVICE
PFAC_PLATFORM_CPU = Platform.CPU
PFAC_PLATFORM_CPU_OMP = Platform.CPU_PARALLEL
PFAC_AUTOMATIC = PlacementMode.AUTO
PFAC_TEXTURE_ON = PlacementMode.VMEM
PFAC_TEXTURE_OFF = PlacementMode.HBM
PFAC_TIME_DRIVEN = PerfMode.DENSE
PFAC_SPACE_DRIVEN = PerfMode.HASH

PFAC_STATUS_SUCCESS = PfacStatus.SUCCESS
PFAC_STATUS_ALLOC_FAILED = PfacStatus.ALLOC_FAILED
PFAC_STATUS_CUDA_ALLOC_FAILED = PfacStatus.DEVICE_ALLOC_FAILED
PFAC_STATUS_INVALID_HANDLE = PfacStatus.INVALID_HANDLE
PFAC_STATUS_INVALID_PARAMETER = PfacStatus.INVALID_PARAMETER
PFAC_STATUS_PATTERNS_NOT_READY = PfacStatus.PATTERNS_NOT_READY
PFAC_STATUS_FILE_OPEN_ERROR = PfacStatus.FILE_OPEN_ERROR
PFAC_STATUS_LIB_NOT_EXIST = PfacStatus.LIB_NOT_EXIST
PFAC_STATUS_ARCH_MISMATCH = PfacStatus.ARCH_MISMATCH
PFAC_STATUS_MUTEX_ERROR = PfacStatus.MUTEX_ERROR
PFAC_STATUS_INTERNAL_ERROR = PfacStatus.INTERNAL_ERROR


class _Handle:
    """Mutable context: modes may be set before patterns are loaded."""

    def __init__(self):
        self.matcher: Matcher | None = None
        self.platform = Platform.DEVICE
        self.perf_mode = PerfMode.DENSE
        self.placement = PlacementMode.AUTO


def PFAC_create(handle_out: MutableSequence) -> PfacStatus:
    """reference: PFAC/src/PFAC.cpp:133-204 (arch dispatch is XLA's job here)."""
    if handle_out is None:
        return PfacStatus.INVALID_HANDLE
    handle_out.insert(0, _Handle())
    return PfacStatus.SUCCESS


def PFAC_destroy(handle: _Handle) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    handle.matcher = None
    return PfacStatus.SUCCESS


def PFAC_setPlatform(handle: _Handle, platform) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.platform = Platform(int(platform))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_platform(handle.platform)
    return PfacStatus.SUCCESS


def PFAC_setTextureMode(handle: _Handle, texture_mode) -> PfacStatus:
    """Validates and records the mode with the reference's status codes.
    The engine does not depend on it: it is chosen from the platform."""
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.placement = PlacementMode(int(texture_mode))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_placement(handle.placement)
    return PfacStatus.SUCCESS


def PFAC_setPerfMode(handle: _Handle, perf_mode) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    try:
        handle.perf_mode = PerfMode(int(perf_mode))
    except ValueError:
        return PfacStatus.INVALID_PARAMETER
    if handle.matcher is not None:
        handle.matcher.set_perf_mode(handle.perf_mode)
    return PfacStatus.SUCCESS


def PFAC_getErrorString(status) -> str:
    from ..status import get_error_string

    return get_error_string(status)


def PFAC_readPatternFromFile(handle: _Handle, filename: str) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if filename is None:
        return PfacStatus.INVALID_PARAMETER
    try:
        automaton = Automaton.from_pattern_file(filename)
        handle.matcher = Matcher(
            automaton=automaton,
            perf_mode=handle.perf_mode,
            platform=handle.platform,
            placement=handle.placement,
        )
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_dumpTransitionTable(handle: _Handle, fp=None) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if fp is None:
        fp = sys.stdout
    try:
        handle.matcher.dump_transition_table(fp)
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_memoryUsage(handle: _Handle) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    sys.stdout.write(handle.matcher.memory_usage())
    return PfacStatus.SUCCESS


def _match_common(handle, input_data, size, matched_result) -> PfacStatus:
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if input_data is None or matched_result is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        result = handle.matcher.match(input_data[:size])
        matched_result[: len(result)] = result
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromHost(handle, h_input, size, h_matched_result) -> PfacStatus:
    """reference: PFAC/src/PFAC.cpp:879-961."""
    return _match_common(handle, h_input, size, h_matched_result)


def PFAC_matchFromDevice(handle, d_input, size, d_matched_result) -> PfacStatus:
    """Device-array variant; d_matched_result must be a list-like cell the
    padded device result is written into (device arrays are immutable in JAX).
    """
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if d_input is None or d_matched_result is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        d_matched_result.insert(0, handle.matcher.match_device(d_input))
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromHostReduce(
    handle, h_input, size, h_matched_result, h_pos, h_num_matched: MutableSequence
) -> PfacStatus:
    """reference: PFAC/src/PFAC.cpp:1010-1128. Writes the compacted
    (id, pos) pairs into the first `count` slots, count into h_num_matched[0].
    """
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if h_input is None or h_matched_result is None or h_pos is None or h_num_matched is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        ids, pos, count = handle.matcher.match_reduce(h_input[:size])
        h_matched_result[:count] = ids
        h_pos[:count] = pos
        h_num_matched.insert(0, count)
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS


def PFAC_matchFromDeviceReduce(
    handle, d_input, size, d_matched_result: MutableSequence,
    d_pos: MutableSequence, h_num_matched: MutableSequence
) -> PfacStatus:
    """Device-resident compacted match: device ids and positions (valid
    up to the count), count written into h_num_matched[0]."""
    if not isinstance(handle, _Handle):
        return PfacStatus.INVALID_HANDLE
    if handle.matcher is None:
        return PfacStatus.PATTERNS_NOT_READY
    if d_input is None:
        return PfacStatus.INVALID_PARAMETER
    if size == 0:
        return PfacStatus.SUCCESS
    try:
        ids, pos, count = handle.matcher.match_reduce_device(d_input)
        d_matched_result.insert(0, ids)
        d_pos.insert(0, pos)
        h_num_matched.insert(0, int(count))
    except PfacError as e:
        return e.status
    except Exception:
        return PfacStatus.INTERNAL_ERROR
    return PfacStatus.SUCCESS

