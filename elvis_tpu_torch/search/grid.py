"""Grid search driver (port of ``elvis_tpu.search.grid``).

The cartesian product over a parameter grid, a validity filter (block size
divides both dimensions, aspect ratio in [5/4, 21/9]), one slug directory
per run, the metric sections extracted into the rewritten analysis JSON,
and a ``runs_summary.json`` roll-up. Every injected key is a declared
``ElvisConfig`` field. A run that raises is recorded as failed and the sweep
goes on (the reference's keep-going policy). The figure roll-up
(``search.plots``; ``minimal_figures`` in the grid trims it to the core
set) is best-effort: without matplotlib or pandas it prints why it was
skipped and the sweep still returns.
"""

from __future__ import annotations

import itertools
import json
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

from elvis_tpu_torch.pipeline.config import config_from_dict
from elvis_tpu_torch.pipeline.run import run_elvis

__all__ = ["DEFAULT_PARAMETER_GRID", "grid_search", "is_valid_overrides", "slugify"]

_ASPECT_RATIO_MIN = 5 / 4
_ASPECT_RATIO_MAX = 21 / 9

DEFAULT_PARAMETER_GRID: Dict[str, List[Any]] = {
    "reference_video": ["synthetic://moving?frames=24"],
    "width": [640],
    "height": [360],
    "block_size": [8, 16],
    "shrink_amount": [0.25, 0.5],
    "removability_alpha": [0.25, 0.75],
    "removability_smoothing_beta": [0.25, 0.75],
    "quality_factor": [1.2],
    "enable_fvmd": [False],
    "generate_opencv_benchmarks": [False],
}

_SLUG_CHARMAP = str.maketrans({"/": "-", "\\": "-", " ": "-", ".": "p"})
_SLUG_KEEP = re.compile(r"[^0-9A-Za-z_-]")


def slugify(parts: Dict[str, Any]) -> str:
    """Deterministic run-directory name from override values ('.' -> 'p',
    path separators -> '-', other non-alphanumerics dropped), the reference's
    naming, so existing tooling resolves the directories."""

    def clean(value: Any) -> str:
        return _SLUG_KEEP.sub("", str(value).translate(_SLUG_CHARMAP))

    return "_".join(f"{key}-{clean(value)}" for key, value in parts.items())


def is_valid_overrides(overrides: Dict[str, Any]) -> bool:
    """The config sanity filter: positive sizes, the block size dividing
    both, and an aspect ratio in [5/4, 21/9]."""
    width = overrides.get("width", 640)
    height = overrides.get("height", 360)
    block = overrides.get("block_size", 8)
    if width <= 0 or height <= 0 or block <= 0:
        return False
    if width % block or height % block:
        return False
    ratio = width / height
    return _ASPECT_RATIO_MIN <= ratio <= _ASPECT_RATIO_MAX + 1e-9


def extract_metric_sections(analysis: Dict[str, Any]) -> Dict[str, Any]:
    """The result rows: entries with a foreground and a background section."""
    return {k: v for k, v in analysis.items()
            if isinstance(v, dict) and "foreground" in v and "background" in v}


def _run_one(overrides: Dict[str, Any], results_dir: Path, varying: List[str],
             device: "str | object" = "cuda") -> Optional[Dict]:
    slug = slugify({k: overrides[k] for k in varying}) or "run"
    run_dir = results_dir / slug
    if run_dir.exists():
        shutil.rmtree(run_dir)
    run_dir.mkdir(parents=True)
    cfg = config_from_dict({**overrides, "experiment_dir": str(run_dir)})
    try:
        analysis = run_elvis(cfg, device=device)
    except Exception as exc:  # the reference's keep-going policy
        print(f"Run {slug} failed: {exc}")
        return {"slug": slug, "status": "failed", "error": str(exc), "overrides": overrides}
    labeled = {
        "label": slug,
        "overrides": overrides,
        "metrics": extract_metric_sections(analysis),
        "execution_times_seconds": analysis.get("execution_times_seconds", {}),
    }
    with open(run_dir / "analysis_results.json", "w") as f:
        json.dump({**analysis, **labeled}, f, indent=4, default=float)
    return {"slug": slug, "status": "ok", "overrides": overrides,
            "metrics": labeled["metrics"],
            "execution_times_seconds": labeled["execution_times_seconds"],
            "video_resolution": analysis.get("video_resolution"),
            "num_frames": analysis.get("video_length_seconds", 0)
            * analysis.get("video_framerate", 0)}


def _figures(results_path: Path, grid: Dict[str, List[Any]]) -> None:
    """The figure roll-up, best-effort (figures never fail a sweep);
    ``minimal_figures`` in the grid keeps the core set."""
    minimal = bool(grid.get("minimal_figures", [False])[0])
    try:
        from elvis_tpu_torch.search.plots import generate_figures

        generate_figures(str(results_path), minimal=minimal)
    except Exception as exc:  # figures are best-effort, never fail a sweep
        print(f"figure generation skipped: {exc}")


def grid_search(parameter_grid: Optional[Dict[str, List[Any]]] = None,
                results_dir: str = "grid_search_results", max_runs: Optional[int] = None,
                device: "str | object" = "cuda") -> List[Dict]:
    """Every valid combination of ``parameter_grid`` (the default grid when
    None), at most ``max_runs``, each a ``run_elvis`` on ``device`` in its
    own slug directory; returns the summary rows (also in
    ``runs_summary.json``)."""
    grid = parameter_grid or DEFAULT_PARAMETER_GRID
    results_path = Path(results_dir)
    results_path.mkdir(parents=True, exist_ok=True)
    keys = list(grid.keys())
    varying = [k for k in keys if len(grid[k]) > 1]
    summary: List[Dict] = []
    count = 0
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        if not is_valid_overrides(overrides):
            continue
        if max_runs is not None and count >= max_runs:
            break
        count += 1
        entry = _run_one(overrides, results_path, varying or keys, device)
        if entry:
            summary.append(entry)
    with open(results_path / "runs_summary.json", "w") as f:
        json.dump(summary, f, indent=4, default=float)
    _figures(results_path, grid)
    return summary


def main(argv=None, device: "str | object" = "cuda"):
    import argparse

    p = argparse.ArgumentParser(description="elvis-tpu grid search (PyTorch/CUDA port)")
    p.add_argument("--grid", type=str, default=None, help="JSON file of {param: [values]}")
    p.add_argument("--results-dir", type=str, default="grid_search_results")
    p.add_argument("--max-runs", type=int, default=None)
    args = p.parse_args(argv)
    grid = None
    if args.grid:
        with open(args.grid) as f:
            grid = json.load(f)
    grid_search(grid, args.results_dir, args.max_runs, device=device)


if __name__ == "__main__":
    main()
