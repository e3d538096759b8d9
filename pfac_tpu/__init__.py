"""pfac-tpu: exact multi-pattern matching (Parallel Failureless
Aho-Corasick) for NVIDIA GPUs, a JAX/XLA/Pallas rebuild of the
capabilities of the PFAC CUDA library.

Two API surfaces:

* Pythonic:  :class:`pfac_tpu.Matcher` plus :class:`pfac_tpu.Automaton`.
* C-style parity layer: ``pfac_tpu.capi`` exposes ``PFAC_create``,
  ``PFAC_readPatternFromFile``, ``PFAC_matchFromHost`` … with the
  reference's handle/status-code discipline.
"""
from .status import PfacError, PfacStatus, get_error_string
from .core.automaton import Automaton
from .core.parser import ParsedPatterns, parse_pattern_bytes, parse_pattern_file, patterns_from_list
from .runtime.handle import Matcher, Platform, PerfMode, PlacementMode
from .runtime.stream import StreamMatcher

__version__ = "0.1.0"

__all__ = [
    "Automaton",
    "Matcher",
    "ParsedPatterns",
    "PerfMode",
    "PfacError",
    "PfacStatus",
    "Platform",
    "PlacementMode",
    "StreamMatcher",
    "get_error_string",
    "parse_pattern_bytes",
    "parse_pattern_file",
    "patterns_from_list",
]
