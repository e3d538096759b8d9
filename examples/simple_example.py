"""Canonical flow, the reference's simple_example.cpp
(reference: PFAC/test/simple_example.cpp:49-123):

create handle -> load pattern file -> dump transition table ->
match from host -> print per-position pattern IDs.

Run:  python examples/simple_example.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pfac_tpu.runtime import capi
from pfac_tpu.status import PfacStatus

import numpy as np

HERE = os.path.dirname(__file__)
PATTERN_FILE = os.path.join(HERE, "..", "tests", "pattern", "example_pattern")
INPUT_FILE = os.path.join(HERE, "..", "tests", "data", "example_input")


def main() -> int:
    handle = [None]
    assert capi.PFAC_create(handle) == PfacStatus.SUCCESS
    h = handle[0]

    status = capi.PFAC_readPatternFromFile(h, PATTERN_FILE)
    if status != PfacStatus.SUCCESS:
        print(f"Error: fails to read pattern from file, {capi.PFAC_getErrorString(status)}")
        return 1

    with open("table.txt", "w") as fp:
        capi.PFAC_dumpTransitionTable(h, fp)

    with open(INPUT_FILE, "rb") as f:
        data = f.read()
    input_size = len(data)
    matched_result = np.zeros(input_size, dtype=np.int32)

    status = capi.PFAC_matchFromHost(h, data, input_size, matched_result)
    if status != PfacStatus.SUCCESS:
        print(f"Error: fails to PFAC_matchFromHost, {capi.PFAC_getErrorString(status)}")
        return 1

    # the reference's expected output (README.md:113-120)
    print("position |  matched pattern ID")
    for i in range(input_size):
        if matched_result[i] != 0:
            print(f"%5d    %5d" % (i, matched_result[i]))

    capi.PFAC_destroy(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
