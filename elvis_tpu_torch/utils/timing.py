"""Timing, logging and output hygiene (port of ``elvis_tpu.utils.timing``).

  * ``measure_time``: a decorator that logs the wall time of each call and
    may append a JSON record per call to a log file;
  * ``measure_performance``: runs a restorer at CALL time and reports its
    frames/s and, optionally, quality metrics, with a per-row ``status``
    (``"ok"`` or ``"error"`` with the error's text: a failing row is
    recorded, not hidden);
  * ``safe_print`` / ``silence_console_output``: stdout hygiene around
    noisy libraries.

The wall clock of a restorer ends when its output is ready: the device the
output lives on is synchronised first. For a per-stage and per-kernel view,
profile the call with ``torch.profiler``: the codec, scoring and restore
stages record their spans there (``elvis_tpu_torch.utils.trace.span``).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

__all__ = [
    "measure_time",
    "measure_performance",
    "safe_print",
    "silence_console_output",
]


def safe_print(*args, **kwargs) -> None:
    """Print, resilient to a closed or replaced stdout."""
    try:
        print(*args, **kwargs)
        sys.stdout.flush()
    except (ValueError, OSError):
        pass


@contextlib.contextmanager
def silence_console_output():
    """Mute stdout/stderr for noisy vendor calls."""
    saved_out, saved_err = sys.stdout, sys.stderr
    try:
        sys.stdout = io.StringIO()
        sys.stderr = io.StringIO()
        yield
    finally:
        sys.stdout, sys.stderr = saved_out, saved_err


def measure_time(label: Optional[str] = None, log_path: Optional[str] = None):
    """Decorator: wall-time the call; optionally append a JSON record."""

    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            name = label or fn.__name__
            t0 = time.time()
            status = "error"
            try:
                result = fn(*args, **kwargs)
                status = "ok"
                return result
            finally:
                elapsed = time.time() - t0
                safe_print(f"[measure_time] {name}: {elapsed:.3f}s ({status})")
                if log_path:
                    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"name": name, "seconds": elapsed,
                                            "status": status, "ts": time.time()}) + "\n")

        return wrapper

    return deco


def _drain(out) -> None:
    """Wait for the device work that produces ``out``."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure_performance(restore_fn: Callable, frames, *args, reference_frames=None,
                        fg_masks=None, metrics: bool = True, label: Optional[str] = None,
                        exclude=("lpips", "fvmd"), **kwargs) -> Dict:
    """Run a restorer and report frames/s (+ optional quality metrics).

    Returns ``{'label', 'status', 'seconds', 'fps', 'frames', 'error'?,
    'metrics'?}``; the restored frames are under ``'output'``. The metrics
    run on the output's device; ``exclude`` skips the expensive ones by
    name: PSNR/SSIM/MSE always run, 'lpips' and 'fvmd' join when removed
    from it.
    """
    name = label or getattr(restore_fn, "__name__", "restorer")
    n = int(frames.shape[0])
    record: Dict = {"label": name, "frames": n}
    t0 = time.time()
    try:
        out = restore_fn(frames, *args, **kwargs)
        _drain(out)
        record["status"] = "ok"
        record["output"] = out
    except Exception as exc:
        record["status"] = "error"
        record["error"] = f"{type(exc).__name__}: {exc}"
        record["seconds"] = time.time() - t0
        record["fps"] = 0.0
        return record
    record["seconds"] = time.time() - t0
    record["fps"] = n / record["seconds"] if record["seconds"] > 0 else float("inf")

    if metrics and reference_frames is not None:
        from elvis_tpu_torch.metrics import masked_mse, masked_psnr, masked_ssim

        dev = out.device if isinstance(out, torch.Tensor) else torch.device("cpu")
        ref = torch.as_tensor(reference_frames, device=dev).float()
        dec = torch.as_tensor(out, device=dev).float()
        m: Dict = {
            "psnr": float(masked_psnr(ref, dec).mean()),
            "ssim": float(masked_ssim(ref, dec).mean()),
            "mse": float(masked_mse(ref, dec).mean()),
        }
        if fg_masks is not None:
            fg = torch.as_tensor(fg_masks, device=dev).bool()
            m["fg_psnr"] = float(masked_psnr(ref, dec, fg).mean())
            m["bg_psnr"] = float(masked_psnr(ref, dec, ~fg).mean())
        excluded = {e.lower() for e in (exclude or ())}
        if "lpips" not in excluded:
            try:
                from elvis_tpu_torch.metrics.perceptual import lpips_distance

                m["lpips"] = float(lpips_distance(ref, dec).mean())
            except Exception as exc:  # no weights file / frames too small
                m["lpips_error"] = f"{type(exc).__name__}: {exc}"
        if "fvmd" not in excluded:
            try:
                from elvis_tpu_torch.metrics.fvmd import fvmd

                m["fvmd"] = float(fvmd(ref, dec))
            except Exception as exc:
                m["fvmd_error"] = f"{type(exc).__name__}: {exc}"
        record["metrics"] = m
    return record
