"""Restoration registry (port of ``elvis_tpu.restore.registry``).

A restorer is ``fn(frames, maps, block_size, **kw) -> frames`` where
``maps`` is the strength-map sidecar of the matching degradation.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["register_restorer", "get_restorer", "available_restorers"]

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
