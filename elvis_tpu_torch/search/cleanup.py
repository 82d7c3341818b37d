"""Results pruner (port of ``elvis_tpu.search.cleanup``): delete every
artifact but JSON and PNG in each run directory and rename the directories
to their parameter slugs (a SHA1 suffix on overlong names, counters on
collisions)."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Dict, List

from elvis_tpu_torch.search.grid import slugify

__all__ = ["cleanup_results"]

_KEEP_SUFFIXES = {".json", ".png"}
_MAX_NAME = 200


def _prune_dir(run_dir: Path) -> int:
    removed = 0
    for item in sorted(run_dir.rglob("*"), key=lambda p: -len(str(p))):
        if item.is_file() and item.suffix.lower() not in _KEEP_SUFFIXES:
            item.unlink()
            removed += 1
        elif item.is_dir() and not any(item.iterdir()):
            item.rmdir()
    return removed


def _slug_for(run_dir: Path) -> str:
    results = run_dir / "analysis_results.json"
    if not results.exists():
        return run_dir.name
    try:
        with open(results) as f:
            data = json.load(f)
        overrides: Dict = data.get("overrides") or data.get("parameters", {}).get("config", {})
    except (OSError, ValueError, AttributeError):
        return run_dir.name
    slug = slugify({k: overrides[k] for k in sorted(overrides)
                    if not isinstance(overrides[k], (dict, list))})
    if len(slug) > _MAX_NAME:
        digest = hashlib.sha1(slug.encode()).hexdigest()[:8]
        slug = slug[: _MAX_NAME - 9] + "_" + digest
    return slug or run_dir.name


def cleanup_results(results_dir: str) -> List[str]:
    """Prune artifacts and rename run directories; returns the final names."""
    root = Path(results_dir)
    finals: List[str] = []
    for run_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        _prune_dir(run_dir)
        slug = _slug_for(run_dir)
        target = root / slug
        counter = 1
        while target.exists() and target != run_dir:
            target = root / f"{slug}_{counter}"
            counter += 1
        if target != run_dir:
            shutil.move(str(run_dir), str(target))
        finals.append(target.name)
    return finals


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="prune search results")
    p.add_argument("results_dir")
    args = p.parse_args(argv)
    for name in cleanup_results(args.results_dir):
        print(name)


if __name__ == "__main__":
    main()
