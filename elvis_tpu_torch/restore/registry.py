"""Restoration registry (port of ``elvis_tpu.restore.registry``).

A restorer is ``fn(frames, maps, block_size, **kw) -> frames`` where
``maps`` is the strength-map sidecar of the matching degradation.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Tuple

import torch

__all__ = ["register_restorer", "get_restorer", "available_restorers", "safe_restore",
           "RestoreFallbackWarning"]

Restorer = Callable[..., object]

_REGISTRY: Dict[Tuple[str, str], Restorer] = {}


def register_restorer(degradation: str, name: str):
    """degradation in {'removal', 'downsample', 'blur', 'dct_dampen'}."""

    def deco(fn: Restorer) -> Restorer:
        _REGISTRY[(degradation, name)] = fn
        return fn

    return deco


def get_restorer(degradation: str, name: str) -> Restorer:
    try:
        return _REGISTRY[(degradation, name)]
    except KeyError:
        avail = sorted(n for d, n in _REGISTRY if d == degradation)
        raise KeyError(
            f"no restorer {name!r} for degradation {degradation!r}; available: {avail}"
        ) from None


def available_restorers(degradation: "str | None" = None):
    if degradation is None:
        return sorted(_REGISTRY)
    return sorted(n for d, n in _REGISTRY if d == degradation)


class RestoreFallbackWarning(RuntimeWarning):
    """A restorer ran out of device memory and its input was returned."""


def safe_restore(fn: Restorer, frames, *args, **kwargs):
    """Run a restorer under the reference's out-of-memory policy: when the
    card runs out of memory, warn (``RestoreFallbackWarning``) and return
    the input frames untouched. Every other error raises. (The JAX
    package's ``safe_restore`` catches every exception; here a failing
    restorer must not pass for one that returned its input.)

    Returns ``(frames_out, error_or_None)``."""
    try:
        return fn(frames, *args, **kwargs), None
    except torch.cuda.OutOfMemoryError as exc:
        err = f"{type(exc).__name__}: {exc}"
        warnings.warn(f"restorer out of device memory, input returned: {err}",
                      RestoreFallbackWarning, stacklevel=2)
        return frames, err
