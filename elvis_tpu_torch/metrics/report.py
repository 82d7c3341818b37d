"""Summary report printer (port of ``elvis_tpu.metrics.report``): a
foreground/background table of all metrics per approach plus a percentage
trade-off analysis against the first (baseline) entry."""

from __future__ import annotations

import math
from typing import Dict

__all__ = ["format_summary_report", "print_summary_report"]

_METRICS = [
    ("psnr_mean", "PSNR", 2, True),
    ("ssim_mean", "SSIM", 4, True),
    ("mse_mean", "MSE", 1, False),
    ("lpips_mean", "LPIPS", 4, False),
    ("fvmd", "FVMD", 1, False),
]


def _fmt(val: float, prec: int) -> str:
    if val is None or (isinstance(val, float) and math.isnan(val)):
        return "n/a"
    return f"{val:.{prec}f}"


def format_summary_report(results: Dict[str, Dict]) -> str:
    """results: {approach: {'foreground': {...}, 'background': {...},
    'bitrate_mbps': x}} in insertion order (first = baseline)."""
    labels = [k for k, v in results.items() if isinstance(v, dict) and "foreground" in v]
    if not labels:
        return "(no approaches evaluated)"
    lines = []
    header = f"{'Approach':<24} {'Mbps':>7} " + " ".join(
        f"{f'FG {name}':>10} {f'BG {name}':>10}" for _, name, _, _ in _METRICS
    )
    lines.append(header)
    lines.append("-" * len(header))
    for label in labels:
        r = results[label]
        row = [f"{label:<24}", f"{r.get('bitrate_mbps', 0.0):>7.3f}"]
        for key, _, prec, _ in _METRICS:
            row.append(f"{_fmt(r['foreground'].get(key), prec):>10}")
            row.append(f"{_fmt(r['background'].get(key), prec):>10}")
        lines.append(" ".join(row))

    base = results[labels[0]]
    lines.append("")
    lines.append(f"Trade-off vs {labels[0]} (positive = better):")
    for label in labels[1:]:
        r = results[label]
        parts = [f"{label:<24}"]
        for key, name, _, higher_better in _METRICS:
            b = base["foreground"].get(key)
            v = r["foreground"].get(key)
            if not b or b == 0 or (isinstance(v, float) and math.isnan(v)) or (
                isinstance(b, float) and math.isnan(b)
            ):
                parts.append(f"FG {name}: n/a")
                continue
            delta = (v - b) / abs(b) * 100.0
            if not higher_better:
                delta = -delta
            parts.append(f"FG {name}: {delta:+.2f}%")
        lines.append("  " + "  ".join(parts))
    return "\n".join(lines)


def print_summary_report(results: Dict[str, Dict]) -> None:
    print(format_summary_report(results))
