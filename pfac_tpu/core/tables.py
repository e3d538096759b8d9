"""Transition-table code generation: dense (time-driven) and perfect-hash
(space-driven) encodings.

Reference behavior being reproduced:

* Dense table: ``numOfStates x 256`` int32 matrix initialized to trap,
  filled from the compact trie in insertion order (later duplicates win)
  (reference: PFAC/src/PFAC.cpp:345-402).
* Perfect hash (MFPH): per-state bin of Bi valid transitions packed into
  Si slots, Si the power of two from the reference's fixed schedule;
  ``row_ptr[s] = (offset, k << 16 | (Si-1))`` and ``val[slot] = (next, ch)``
  with the smallest key ``k in [1,256]`` making
  ``((k*ch) % 257) % Si`` collision-free; rows with no transitions get
  offset -1; a dense 256-entry row is additionally materialized for the
  initial state (reference: PFAC/src/PFAC.cpp:422-648,
  PFAC/include/PFAC_P.h:56-91).

Both encodings run on the device (backends/): the hash table at ~1/50th
the dense size, the dense table with one gather per step. Their device
variants remap trap to state 0 (see backends/xla.py), which gives the
branch-free inner loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..status import PfacError, PfacStatus
from .trie import CHAR_SET, TRAP_STATE, CompactTrie

HASH_P = 257          # prime 2^m + 1 (reference: PFAC/src/PFAC.cpp:437-438)
HASH_M = 8
HASH_KEY_K_MASKBITS = 16
HASH_KEY_S_MASK = 0xFFFF


@dataclasses.dataclass
class DenseTable:
    """Time-driven encoding: table[s, ch] = next state, trap = -1."""

    table: np.ndarray  # int32 [num_states, 256]

    @property
    def num_states(self) -> int:
        return self.table.shape[0]

    @property
    def num_entries(self) -> int:
        return self.table.size

    @property
    def size_in_bytes(self) -> int:
        return self.table.size * 4


@dataclasses.dataclass
class HashTable:
    """Space-driven encoding (modulo-free perfect hash).

    row_ptr: int32 [num_states, 2] — (offset | -1, k<<16 | (Si-1))
    val:     int32 [num_entries, 2] — (next_state, ch), empty slots = -1
    init_row: int32 [256] — dense row for the initial state, trap = -1
    """

    row_ptr: np.ndarray
    val: np.ndarray
    init_row: np.ndarray
    hash_p: int = HASH_P
    hash_m: int = HASH_M

    @property
    def num_states(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def num_entries(self) -> int:
        return self.val.shape[0]

    @property
    def size_in_bytes(self) -> int:
        # reference reports only the val array as "sizeOfTableInBytes"
        return self.val.size * 4


def build_dense_table(trie: CompactTrie) -> DenseTable:
    table = np.full((trie.num_states, CHAR_SET), TRAP_STATE, dtype=np.int32)
    for state, row in enumerate(trie.rows):
        for ch, nxt in row:
            table[state, ch] = nxt
    return DenseTable(table=table)


def _bin_size(bi: int) -> int:
    """Reference's Bi -> Si slot schedule (PFAC/src/PFAC.cpp:448-473)."""
    if bi == 0:
        return 0
    if bi == 1:
        return 1
    if bi <= 2:
        return 4
    if bi <= 4:
        return 16
    if bi == 5:
        return 32
    if bi <= 8:
        return 64
    if bi <= 11:
        return 128
    if bi <= 255:
        return 256
    raise PfacError(PfacStatus.INTERNAL_ERROR, f"row with {bi} transitions")


def _find_key(chars: list[int], si: int) -> int:
    """Smallest k in [1,256] such that ((k*ch) % 257) % Si is collision-free."""
    for k in range(1, CHAR_SET + 1):
        seen = 0
        ok = True
        for ch in chars:
            pos = ((k * ch) % HASH_P) % si
            bit = 1 << pos
            if seen & bit:
                ok = False
                break
            seen |= bit
        if ok:
            return k
    raise PfacError(PfacStatus.INTERNAL_ERROR, "no perfect-hash key k <= 256 found")


def build_hash_table(trie: CompactTrie) -> HashTable:
    s = trie.num_states
    row_ptr = np.empty((s, 2), dtype=np.int32)
    sis = np.empty(s, dtype=np.int64)

    total = 0
    for i in range(s):
        bi = len(trie.rows[i])
        si = _bin_size(bi)
        sis[i] = si
        if bi == 0:
            row_ptr[i, 0] = -1
            row_ptr[i, 1] = -1
        else:
            row_ptr[i, 0] = total
            row_ptr[i, 1] = si - 1  # k filled below
            total += si

    val = np.full((total, 2), -1, dtype=np.int32)

    for i in range(s):
        row = trie.rows[i]
        if not row:
            continue
        si = int(sis[i])
        offset = int(row_ptr[i, 0])
        if si in (1, CHAR_SET):
            # identity key: ((1*ch) % 257) % 256 == ch for ch < 256
            k = 1
        else:
            k = _find_key([ch for ch, _ in row], si)
        for ch, nxt in row:
            pos = ((k * ch) % HASH_P) % si
            val[offset + pos, 0] = nxt
            val[offset + pos, 1] = ch
        row_ptr[i, 1] = np.int32((k << HASH_KEY_K_MASKBITS) | (si - 1))

    # dense row for the initial state (reference: PFAC/src/PFAC.cpp:564-594)
    init_row = np.full(CHAR_SET, TRAP_STATE, dtype=np.int32)
    offset = int(row_ptr[trie.initial_state, 0])
    if offset >= 0:
        k_sminus1 = int(row_ptr[trie.initial_state, 1])
        sminus1 = k_sminus1 & HASH_KEY_S_MASK
        k = k_sminus1 >> HASH_KEY_K_MASKBITS
        for j in range(CHAR_SET):
            pos = ((k * j) % HASH_P) & sminus1
            nxt, ch = int(val[offset + pos, 0]), int(val[offset + pos, 1])
            init_row[j] = nxt if ch == j else TRAP_STATE

    return HashTable(row_ptr=row_ptr, val=val, init_row=init_row)


def hash_lookup(ht: HashTable, state: int, ch: int) -> int:
    """Scalar probe, the oracle for kernels (reference: PFAC_CPU.cpp:103-163)."""
    offset = int(ht.row_ptr[state, 0])
    if offset < 0:
        return TRAP_STATE
    k_sminus1 = int(ht.row_ptr[state, 1])
    sminus1 = k_sminus1 & HASH_KEY_S_MASK
    k = k_sminus1 >> HASH_KEY_K_MASKBITS
    # modulo-free reduction of (k*ch) mod 257: x = 256 q + r ≡ r - q (mod 257)
    x = k * ch
    beta = (x & 0xFF) - (x >> HASH_M)
    if beta < 0:
        beta += HASH_P
    pos = beta & sminus1
    nxt, c = int(ht.val[offset + pos, 0]), int(ht.val[offset + pos, 1])
    return nxt if c == ch else TRAP_STATE
