"""Content-addressed stage cache (port of ``elvis_tpu.pipeline.cache``).

A stage's outputs are cached under a key hashing (stage name, config
slice, input digests); re-running a config skips completed stages. The
cache holds host numpy copies in one ``.npz`` per stage; a hit moves the
arrays back to the device the caller names. The digest of a tensor is the
digest of its host copy, so a key equals the JAX package's for the same
objects.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["StageCache"]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _digest(obj: Any) -> str:
    h = hashlib.sha1()

    def feed(x):
        x = _host(x)
        if isinstance(x, np.ndarray):
            h.update(str(x.shape).encode())
            h.update(str(x.dtype).encode())
            # the whole buffer: a prefix digest would serve stale stages for
            # arrays that differ only past the prefix
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (bytes, bytearray)):
            h.update(bytes(x))
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        else:
            h.update(json.dumps(x, default=str, sort_keys=True).encode())

    feed(obj)
    return h.hexdigest()[:16]


class StageCache:
    def __init__(self, root: Optional[str], enabled: bool = True):
        self.root = root
        self.enabled = enabled and root is not None
        # which stages were served from disk vs run, surfaced as
        # analysis_results["stage_cache"] by run_elvis
        self.hits: list = []
        self.misses: list = []
        if self.enabled:
            os.makedirs(root, exist_ok=True)

    def get_or_run(
        self, stage: str, key_parts: Any, fn: Callable[[], Dict[str, Any]],
        device: "str | torch.device | None" = None,
    ) -> Dict[str, Any]:
        """``fn`` returns a dict of tensors, arrays or bytes, cached as one
        npz. With ``device``, arrays come back as tensors on it, from a hit
        and from a miss alike; bytes stay bytes."""
        if not self.enabled:
            return self._place(fn(), device)
        key = _digest([stage, key_parts])
        path = os.path.join(self.root, f"{stage}_{key}.npz")
        if os.path.exists(path):
            out = {}
            with np.load(path, allow_pickle=False) as data:
                for k in data.files:
                    if k.endswith("__bytes"):
                        out[k[: -len("__bytes")]] = data[k].tobytes()
                    else:
                        out[k] = data[k]
            self.hits.append(stage)
            return self._place(out, device)
        self.misses.append(stage)
        result = fn()
        to_save = {}
        for k, v in result.items():
            if isinstance(v, (bytes, bytearray)):
                to_save[k + "__bytes"] = np.frombuffer(bytes(v), dtype=np.uint8)
            else:
                to_save[k] = np.asarray(_host(v))
        np.savez(path, **to_save)
        return self._place(result, device)

    @staticmethod
    def _place(result: Dict[str, Any], device) -> Dict[str, Any]:
        if device is None:
            return result
        return {k: v if isinstance(v, (bytes, bytearray))
                else torch.as_tensor(v, device=device) for k, v in result.items()}
