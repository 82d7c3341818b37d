"""Random search driver (port of ``elvis_tpu.search.random_search``): the
grid driver's space, seeded unique sampling with rejection, and an
exhaustive enumeration (shuffled) when the space is small."""

from __future__ import annotations

import itertools
import json
import random
from pathlib import Path
from typing import Any, Dict, List, Optional

from elvis_tpu_torch.search.grid import (
    DEFAULT_PARAMETER_GRID,
    _figures,
    _run_one,
    is_valid_overrides,
)

__all__ = ["random_search"]


def _space_size(grid: Dict[str, List[Any]]) -> int:
    size = 1
    for v in grid.values():
        size *= len(v)
    return size


def random_search(parameter_grid: Optional[Dict[str, List[Any]]] = None, runs: int = 10,
                  seed: int = 0, results_dir: str = "random_search_results",
                  device: "str | object" = "cuda") -> List[Dict]:
    """``runs`` distinct valid combinations drawn with ``random.Random(seed)``
    (the JAX package's draws: the same runs in the same order), each a
    ``run_elvis`` on ``device``; returns the summary rows (also in
    ``runs_summary.json``)."""
    grid = parameter_grid or DEFAULT_PARAMETER_GRID
    results_path = Path(results_dir)
    results_path.mkdir(parents=True, exist_ok=True)
    keys = list(grid.keys())
    varying = [k for k in keys if len(grid[k]) > 1]
    rng = random.Random(seed)

    chosen: List[Dict[str, Any]] = []
    seen = set()
    if _space_size(grid) <= runs * 4:
        # small space: enumerate, keep the valid ones, shuffle
        all_combos = [dict(zip(keys, c)) for c in itertools.product(*(grid[k] for k in keys))]
        valid = [c for c in all_combos if is_valid_overrides(c)]
        rng.shuffle(valid)
        chosen = valid[:runs]
    else:
        attempts = 0
        while len(chosen) < runs and attempts < runs * 200:
            attempts += 1
            combo = {k: rng.choice(grid[k]) for k in keys}
            key = tuple(sorted((k, str(v)) for k, v in combo.items()))
            if key in seen or not is_valid_overrides(combo):
                continue
            seen.add(key)
            chosen.append(combo)

    summary: List[Dict] = []
    for overrides in chosen:
        entry = _run_one(overrides, results_path, varying or keys, device)
        if entry:
            summary.append(entry)
    with open(results_path / "runs_summary.json", "w") as f:
        json.dump(summary, f, indent=4, default=float)
    _figures(results_path, grid)
    return summary


def main(argv=None, device: "str | object" = "cuda"):
    import argparse

    p = argparse.ArgumentParser(description="elvis-tpu random search (PyTorch/CUDA port)")
    p.add_argument("--grid", type=str, default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results-dir", type=str, default="random_search_results")
    args = p.parse_args(argv)
    grid = None
    if args.grid:
        with open(args.grid) as f:
            grid = json.load(f)
    random_search(grid, args.runs, args.seed, args.results_dir, device=device)


if __name__ == "__main__":
    main()
