"""Status codes and error strings for the pfac-tpu framework.

Mirrors the reference C API's error surface (reference: PFAC/include/PFAC.h:57-70,
PFAC/src/PFAC.cpp:1131-1183) while also exposing idiomatic Python exceptions.
The numeric values match the reference so applications porting from the C
library see identical codes.
"""
from __future__ import annotations

import enum


class PfacStatus(enum.IntEnum):
    """Status codes. Values match the reference `PFAC_status_t`.

    The reference reserves codes < 10000 for raw CUDA errors; we keep the
    10000 base for compatibility but never emit device-runtime codes.
    """

    SUCCESS = 0
    BASE = 10000
    ALLOC_FAILED = 10001
    DEVICE_ALLOC_FAILED = 10002      # reference: PFAC_STATUS_CUDA_ALLOC_FAILED
    INVALID_HANDLE = 10003
    INVALID_PARAMETER = 10004
    PATTERNS_NOT_READY = 10005
    FILE_OPEN_ERROR = 10006
    LIB_NOT_EXIST = 10007
    ARCH_MISMATCH = 10008
    MUTEX_ERROR = 10009
    INTERNAL_ERROR = 10010


_ERROR_STRINGS = {
    PfacStatus.SUCCESS: "PFAC_STATUS_SUCCESS: operation is successful",
    PfacStatus.ALLOC_FAILED: "PFAC_STATUS_ALLOC_FAILED: allocation fails on host memory",
    PfacStatus.DEVICE_ALLOC_FAILED: "PFAC_STATUS_CUDA_ALLOC_FAILED: allocation fails on device memory",
    PfacStatus.INVALID_HANDLE: "PFAC_STATUS_INVALID_HANDLE: handle is invalid (NULL)",
    PfacStatus.INVALID_PARAMETER: "PFAC_STATUS_INVALID_PARAMETER: parameter is invalid",
    PfacStatus.PATTERNS_NOT_READY: "PFAC_STATUS_PATTERNS_NOT_READY: please call PFAC_readPatternFromFile() first",
    PfacStatus.FILE_OPEN_ERROR: "PFAC_STATUS_FILE_OPEN_ERROR: pattern file does not exist",
    PfacStatus.LIB_NOT_EXIST: "PFAC_STATUS_LIB_NOT_EXIST: cannot find PFAC library, please check LD_LIBRARY_PATH",
    PfacStatus.ARCH_MISMATCH: "PFAC_STATUS_ARCH_MISMATCH: sm1.0 is not supported",
    PfacStatus.MUTEX_ERROR: "PFAC_STATUS_MUTEX_ERROR: please report bugs. Workaround: choose non-texture mode.",
    PfacStatus.INTERNAL_ERROR: "PFAC_STATUS_INTERNAL_ERROR: please report bugs",
}


def get_error_string(status: PfacStatus | int) -> str:
    """Equivalent of `PFAC_getErrorString` (reference: PFAC/src/PFAC.cpp:1131-1183)."""
    try:
        status = PfacStatus(int(status))
    except ValueError:
        return _ERROR_STRINGS[PfacStatus.INTERNAL_ERROR]
    return _ERROR_STRINGS.get(status, _ERROR_STRINGS[PfacStatus.INTERNAL_ERROR])


class PfacError(RuntimeError):
    """Idiomatic exception carrying a PfacStatus; raised by the pythonic API."""

    def __init__(self, status: PfacStatus, detail: str = ""):
        self.status = PfacStatus(status)
        msg = get_error_string(self.status)
        if detail:
            msg = f"{msg} ({detail})"
        super().__init__(msg)
