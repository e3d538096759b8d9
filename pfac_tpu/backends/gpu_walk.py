"""Hopper walk kernel: one failureless walk per start byte.

The reference's CUDA kernels (PFAC/src/PFAC_kernel.cu:377-458 dense,
PFAC/src/PFAC_kernel_spaceDriven.cu:465-558 hash) give every thread one
start position and let it walk until the trap state. This is the same
design written for the card through Pallas's Triton route:

* A 1-D grid. Each program owns ``block`` consecutive start positions
  (one lane each) and writes their int32 match ids.
* The raw ``uint8`` input is read directly. Reads at or past ``n`` are
  masked and stand for the end-of-input byte ``SENTINEL``, whose table
  column is all-trap, so a walk that runs off the data dies there.
* The first two steps are one gather each into the fused pair tables
  (``xla.pair_tables``). They play the part of the reference's
  initial-state row in shared memory: most walks end within them.
* The rest is a loop on the device that runs while ``d < max_len`` and
  any lane of the block is alive: early exit per block, nothing read
  back on the host. A step is the dense gather ``table[state*257+ch]``
  or the modulo-free perfect-hash probe, with gathers masked to the
  lanes that are still alive.

``GpuWalkMatcher`` has the interface of ``xla.XlaMatcher`` and shares
its device tables; only the walk differs. Off the GPU the kernel runs
only in interpret mode, which is for tests.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.tables import HASH_KEY_K_MASKBITS, HASH_KEY_S_MASK
from ..status import PfacError, PfacStatus
from .xla import SENTINEL, STRIDE, XlaMatcher

DEFAULT_BLOCK = 256     # start positions per program (tuned on H100)
DEFAULT_WARPS = 2
#: largest state count whose dense index state*257+ch stays in int32
MAX_DENSE_STATES = ((1 << 31) - 1 - SENTINEL) // STRIDE + 1
#: the kernel addresses positions as int32; keep room for the longest
#: walk and a block of overshoot past the last position
MAX_INPUT_BYTES = (1 << 31) - (1 << 22)


def check_dense_index(num_states: int) -> None:
    """Refuse a dense table whose flat index would wrap int32."""
    if num_states > MAX_DENSE_STATES:
        raise PfacError(
            PfacStatus.INVALID_PARAMETER,
            f"{num_states} states: the dense index state*257+ch would "
            f"overflow int32 (limit {MAX_DENSE_STATES}); use perf_mode='hash'",
        )


def _walk_kernel(n_ref, data_ref, ps_ref, pm_ref, *refs, mode: str,
                 block: int, num_final: int, max_len: int):
    *tabs, out_ref = refs
    base = pl.program_id(0) * block
    n = n_ref[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)

    def byte_at(d):
        valid = base + d + lane < n
        ch = plgpu.load(data_ref.at[pl.ds(base + d, block)], mask=valid,
                        other=0)
        return jnp.where(valid, ch.astype(jnp.int32), SENTINEL)

    def step(state, ch):
        alive = state > 0
        if mode == "dense":
            (table,) = tabs
            return plgpu.load(table.at[state * STRIDE + ch], mask=alive,
                              other=0)
        rp_off, rp_key, val_next, val_ch = tabs
        off = plgpu.load(rp_off.at[state], mask=alive, other=0)
        key = plgpu.load(rp_key.at[state], mask=alive, other=0)
        # modulo-free (k*ch) mod 257: x = 256q + r  ==>  r - q (mod 257)
        x = (key >> HASH_KEY_K_MASKBITS) * ch
        beta = (x & 0xFF) - (x >> 8)
        beta = jnp.where(beta < 0, beta + 257, beta)
        slot = off + (beta & (key & HASH_KEY_S_MASK))
        nxt = plgpu.load(val_next.at[slot], mask=alive, other=0)
        stored = plgpu.load(val_ch.at[slot], mask=alive, other=-1)
        return jnp.where(stored == ch, nxt, 0)

    pair = byte_at(0) * STRIDE + byte_at(1)
    state = ps_ref[pair]
    match = pm_ref[pair]

    def cond(carry):
        d, state, _ = carry
        return (d < max_len) & (jnp.max(state) > 0)

    def body(carry):
        d, state, match = carry
        state = step(state, byte_at(d))
        match = jnp.where((state > 0) & (state <= num_final), state, match)
        return d + 1, state, match

    if max_len > 2:
        _, _, match = jax.lax.while_loop(cond, body,
                                         (jnp.int32(2), state, match))
    out_ref[...] = match


@functools.partial(jax.jit, static_argnames=(
    "mode", "num_final", "max_len", "num_out", "block", "num_warps",
    "interpret"))
def walk(tables, pair_state, pair_match, data_u8, n_valid, *, mode: str,
         num_final: int, max_len: int, num_out: int,
         block: int = DEFAULT_BLOCK, num_warps: int = DEFAULT_WARPS,
         interpret: bool = False) -> jax.Array:
    """Match ids for start positions [0, num_out) of ``data_u8``.

    ``n_valid`` (int32[1]) is the number of real bytes: reads at or past
    it are the end of input. ``num_out`` must be a multiple of ``block``;
    positions at or past ``n_valid`` report 0.
    """
    if num_out % block:
        raise ValueError(f"num_out {num_out} is not a multiple of {block}")
    kernel = functools.partial(_walk_kernel, mode=mode, block=block,
                               num_final=num_final, max_len=max_len)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((num_out,), jnp.int32),
        grid=(num_out // block,),
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=f"pfac_walk_{mode}",
    )(n_valid, data_u8, pair_state, pair_match, *tables)


def padded_len(n: int, block: int) -> int:
    """Start positions computed for an n-byte input: a block multiple."""
    return max(1, -(-n // block)) * block


@dataclasses.dataclass
class GpuWalkMatcher(XlaMatcher):
    """``XlaMatcher`` with the walk done by the Hopper kernel.
    ``interpret=True`` runs it in the Pallas interpreter (tests only)."""

    interpret: bool = False

    def __post_init__(self):
        if self.perf_mode == "dense":
            check_dense_index(self.automaton.num_states)
        super().__post_init__()

    @property
    def tables(self) -> tuple:
        if self.perf_mode == "dense":
            return (self._table_flat,)
        return (self._rp_off, self._rp_key, self._val_next, self._val_ch)

    def walk_kwargs(self) -> dict:
        a = self.automaton
        return dict(mode=self.perf_mode, num_final=a.num_final_states,
                    max_len=a.max_pattern_len, interpret=self.interpret)

    def match_device(self, data_u8: jax.Array) -> jax.Array:
        """uint8[N] on device -> int32[padded_len(N)] match ids."""
        n = int(data_u8.shape[0])
        if n > MAX_INPUT_BYTES:
            raise PfacError(
                PfacStatus.INVALID_PARAMETER,
                f"{n} bytes exceed the int32 position range; stream the "
                "input (Matcher.match does) or shard it",
            )
        # on the engine's device, beside its tables
        n_valid = jax.device_put(np.full(1, n, np.int32), self.device)
        return walk(self.tables, self._pair_state, self._pair_match,
                    data_u8, n_valid,
                    num_out=padded_len(n, DEFAULT_BLOCK), **self.walk_kwargs())

