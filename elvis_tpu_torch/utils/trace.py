"""The port's instruments: spans on the profiler's clock and one registry of
named counters.

  * ``span(name)``: a context manager. While a ``torch.profiler`` profile
    is active it opens ``record_function(name)``, so the span lands in the
    same trace as the device operations it launches, on the same clock and
    on the calling thread; otherwise it returns one shared no-op object
    (under a microsecond). The profiler's state is the only switch.
  * ``counter(family)``: the registered ``collections.Counter`` of a
    family, made at first use; the same object on every call.
  * ``counters()``: a flat snapshot of every family, ``{"<family>.<key>": n}``.

Spans mark stages (a codec call, a plane's frame, a restore stage), never a
row or a kernel: while a profile records, each is a host event of its own,
which would slow and crowd a per-row loop.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch
from torch.profiler import record_function

__all__ = ["span", "counter", "counters"]

_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, "collections.Counter[str]"] = {}


def span(name: str):
    """``record_function(name)`` while a profile records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def counter(family: str) -> "collections.Counter[str]":
    """The registry's counter of ``family``."""
    return _COUNTERS.setdefault(family, collections.Counter())


def counters() -> Dict[str, int]:
    """Every counter's every key, as ``{"<family>.<key>": n}``."""
    return {f"{family}.{key}": n for family, c in _COUNTERS.items() for key, n in c.items()}
