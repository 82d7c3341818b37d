"""Search-result figures (port of ``elvis_tpu.search.plots``).

The grid-search notebook's figure set over a results directory: the
runs aggregated; FG-vs-BG scatter per metric; per-approach metric box and
violin distributions; the approach-vs-baseline offset heatmap; stage
throughput bars; the parameter / metric Pearson correlation heatmap. Figure
names follow the notebook's conventions. Host work only: matplotlib and
pandas are imported inside the functions (neither is needed to import the
module); ``minimal`` keeps the core FG-vs-BG scatters.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["load_runs", "runs_to_dataframe", "generate_figures", "classify_stage"]

_METRICS = ["psnr_mean", "ssim_mean", "mse_mean", "lpips_mean"]


def load_runs(results_dir: str) -> List[Dict]:
    """Collect per-run metric dicts from runs_summary.json or the
    individual analysis_results.json files."""
    root = Path(results_dir)
    summary = root / "runs_summary.json"
    if summary.exists():
        with open(summary) as f:
            runs = json.load(f)
        return [r for r in runs if r.get("status") == "ok"]
    runs = []
    for res in sorted(root.glob("*/analysis_results.json")):
        with open(res) as f:
            data = json.load(f)
        runs.append({
            "slug": res.parent.name,
            "status": "ok",
            "overrides": data.get("overrides", data.get("parameters", {}).get("config", {})),
            "metrics": {
                k: v for k, v in data.items()
                if isinstance(v, dict) and "foreground" in v
            },
            "execution_times_seconds": data.get("execution_times_seconds", {}),
            "video_resolution": data.get("video_resolution"),
            "num_frames": data.get("video_length_seconds", 0)
            * data.get("video_framerate", 0),
        })
    return runs


def runs_to_dataframe(runs: List[Dict]):
    """Long-form rows: one per (run, approach, region, metric)."""
    import pandas as pd

    rows = []
    for run in runs:
        for approach, m in run.get("metrics", {}).items():
            for region in ("foreground", "background"):
                if region not in m:
                    continue
                row = {"slug": run["slug"], "approach": approach, "region": region,
                       "bitrate_mbps": m.get("bitrate_mbps")}
                row.update({k: m[region].get(k) for k in _METRICS + ["fvmd"]})
                for pk, pv in (run.get("overrides") or {}).items():
                    if isinstance(pv, (int, float, bool)):
                        row[f"param_{pk}"] = float(pv)
                rows.append(row)
    return pd.DataFrame(rows)


_TASK_BUCKETS = (
    # notebook cell 17's task classifier: stage-timing keys -> task class
    ("Preprocessing", ("Preprocessing",)),
    ("Removability", ("Removability",)),
    ("Baseline", ("Baseline",)),
    ("ELVIS", ("ELVIS", "Inpainting", "Shrinking", "Stretching")),
    ("PRESLEY", ("PRESLEY", "Restoration", "QP Encoding",
                 "Downsampled Encoding", "Gaussian Encoding", "Dampen")),
    ("Evaluation", ("Evaluation", "Benchmarks")),
)


def classify_stage(stage_name: str) -> str:
    for bucket, needles in _TASK_BUCKETS:
        if any(n in stage_name for n in needles):
            return bucket
    return "Other"


def generate_figures(
    results_dir: str, out_dir: Optional[str] = None, *, minimal: bool = False
) -> List[str]:
    """Write the figure set; returns the saved paths. ``minimal`` keeps
    only the core FG-vs-BG scatters (the reference's minimal_figures)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = load_runs(results_dir)
    if not runs:
        return []
    df = runs_to_dataframe(runs)
    out = Path(out_dir or os.path.join(results_dir, "figures"))
    out.mkdir(parents=True, exist_ok=True)
    saved: List[str] = []

    def save(fig, name):
        path = out / name
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        saved.append(str(path))

    # 1. FG vs BG scatter per metric (notebook 'metric_hexbin' family)
    for metric in ("psnr_mean", "ssim_mean"):
        fg = df[df.region == "foreground"].set_index(["slug", "approach"])[metric]
        bg = df[df.region == "background"].set_index(["slug", "approach"])[metric]
        joined = fg.to_frame("fg").join(bg.to_frame("bg")).dropna()
        fig, ax = plt.subplots(figsize=(5, 5))
        for approach, grp in joined.groupby(level="approach"):
            ax.scatter(grp["bg"], grp["fg"], label=approach, s=18, alpha=0.7)
        ax.set_xlabel(f"background {metric}")
        ax.set_ylabel(f"foreground {metric}")
        ax.legend(fontsize=6)
        save(fig, f"fg_vs_bg_{metric}.png")

    if minimal:
        return saved

    # 1b. hexbin + kde views of the same FG-vs-BG relation (notebook
    # 'metric_hexbin' / 'metric_kde' figure names)
    for metric in ("psnr_mean", "ssim_mean"):
        fg = df[df.region == "foreground"].set_index(["slug", "approach"])[metric]
        bg = df[df.region == "background"].set_index(["slug", "approach"])[metric]
        joined = fg.to_frame("fg").join(bg.to_frame("bg")).dropna()
        if len(joined) < 3:
            continue
        fig, ax = plt.subplots(figsize=(5, 4))
        hb = ax.hexbin(joined["bg"], joined["fg"], gridsize=14, cmap="viridis",
                       mincnt=1)
        fig.colorbar(hb, ax=ax, label="runs")
        ax.set_xlabel(f"background {metric}")
        ax.set_ylabel(f"foreground {metric}")
        save(fig, f"metric_hexbin_{metric}.png")

        try:
            from scipy.stats import gaussian_kde

            vals = joined["fg"].values
            if np.unique(vals).size > 2:
                kde = gaussian_kde(vals)
                xs = np.linspace(vals.min(), vals.max(), 200)
                fig, ax = plt.subplots(figsize=(5, 3))
                ax.plot(xs, kde(xs))
                ax.fill_between(xs, kde(xs), alpha=0.3)
                ax.set_xlabel(f"foreground {metric}")
                ax.set_ylabel("density")
                save(fig, f"metric_kde_{metric}.png")
        except Exception:
            pass  # degenerate distributions have no kde

    # 2. per-approach metric distributions (violin + box, notebook cell 3)
    for metric in ("psnr_mean", "ssim_mean"):
        sub = df[df.region == "foreground"][["approach", metric]].dropna()
        if sub.empty:
            continue
        approaches = sorted(sub.approach.unique())
        data = [sub[sub.approach == a][metric].values for a in approaches]
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.boxplot(data, tick_labels=approaches)
        ax.set_ylabel(f"FG {metric}")
        ax.tick_params(axis="x", rotation=45, labelsize=6)
        save(fig, f"distribution_{metric}.png")
        if all(len(d) > 1 for d in data):
            fig, ax = plt.subplots(figsize=(7, 4))
            ax.violinplot(data, showmedians=True)
            ax.set_xticks(range(1, len(approaches) + 1), approaches,
                          rotation=45, fontsize=6)
            ax.set_ylabel(f"FG {metric}")
            save(fig, f"metric_violin_{metric}.png")

    # 2b. throughput: FPS by resolution and task class (notebook cell 17's
    # boxplots + task-classifier stacked timing bars)
    timing_rows = []
    for run in runs:
        times = run.get("execution_times_seconds") or {}
        res = run.get("video_resolution") or "unknown"
        nf = float(run.get("num_frames") or 0)
        for stage, secs in times.items():
            if not isinstance(secs, (int, float)) or secs <= 0:
                continue
            timing_rows.append({
                "slug": run.get("slug", "?"), "resolution": res,
                "task": classify_stage(stage), "stage": stage,
                "seconds": float(secs),
                "fps": (nf / float(secs)) if nf else float("nan"),
            })
    if timing_rows:
        import pandas as pd

        tdf = pd.DataFrame(timing_rows)
        tasks = [t for t, _ in _TASK_BUCKETS if (tdf.task == t).any()]
        resolutions = sorted(tdf.resolution.unique())
        # FPS-by-resolution boxplots per task class
        fig, axes = plt.subplots(
            1, max(len(tasks), 1), figsize=(2.2 * max(len(tasks), 1) + 1, 3.2),
            sharey=True,
        )
        axes = np.atleast_1d(axes)
        for ax, task in zip(axes, tasks):
            data = [
                tdf[(tdf.task == task) & (tdf.resolution == r)]["fps"].dropna().values
                for r in resolutions
            ]
            ax.boxplot([d if len(d) else [np.nan] for d in data],
                       tick_labels=resolutions)
            ax.set_title(task, fontsize=7)
            ax.tick_params(axis="x", rotation=45, labelsize=6)
            ax.set_yscale("log")
        axes[0].set_ylabel("frames/sec")
        save(fig, "fps_by_resolution.png")

        # stacked per-run time bars by task class
        piv = tdf.pivot_table(index="slug", columns="task", values="seconds",
                              aggfunc="sum").fillna(0.0)
        fig, ax = plt.subplots(figsize=(max(4, 0.5 * len(piv)), 3.5))
        bottom = np.zeros(len(piv))
        for task in [t for t, _ in _TASK_BUCKETS if t in piv.columns]:
            ax.bar(range(len(piv)), piv[task].values, bottom=bottom, label=task)
            bottom += piv[task].values
        ax.set_xticks(range(len(piv)), piv.index, rotation=90, fontsize=5)
        ax.set_ylabel("seconds")
        ax.legend(fontsize=6)
        save(fig, "task_time_stacked.png")

    # 3. offset-vs-baseline heatmap
    base = df[(df.approach == "Baseline") & (df.region == "foreground")].set_index("slug")
    others = df[(df.approach != "Baseline") & (df.region == "foreground")]
    if not base.empty and not others.empty:
        piv = {}
        for approach, grp in others.groupby("approach"):
            g = grp.set_index("slug")
            common = g.index.intersection(base.index)
            if len(common):
                piv[approach] = (
                    g.loc[common, "ssim_mean"] - base.loc[common, "ssim_mean"]
                ).mean()
        if piv:
            fig, ax = plt.subplots(figsize=(6, 3))
            names = list(piv)
            vals = [piv[k] for k in names]
            ax.imshow(np.asarray(vals)[None], cmap="RdYlGn", aspect="auto")
            ax.set_xticks(range(len(names)), names, rotation=45, fontsize=6)
            ax.set_yticks([0], ["Δ FG SSIM vs Baseline"])
            for i, v in enumerate(vals):
                ax.text(i, 0, f"{v:+.4f}", ha="center", va="center", fontsize=6)
            save(fig, "offset_vs_baseline_heatmap.png")

    # 4. parameter <-> metric correlation heatmap
    params = [c for c in df.columns if c.startswith("param_")]
    sub = df[df.region == "foreground"]
    corr_rows = []
    for p in params:
        if sub[p].nunique() < 2:
            continue
        corr_rows.append([p] + [
            float(np.corrcoef(sub[p].fillna(0), sub[m].fillna(0))[0, 1])
            if sub[m].notna().any() else 0.0
            for m in _METRICS
        ])
    if corr_rows:
        fig, ax = plt.subplots(figsize=(6, 0.5 * len(corr_rows) + 2))
        mat = np.asarray([r[1:] for r in corr_rows], dtype=float)
        ax.imshow(mat, cmap="coolwarm", vmin=-1, vmax=1, aspect="auto")
        ax.set_xticks(range(len(_METRICS)), _METRICS, rotation=30, fontsize=7)
        ax.set_yticks(range(len(corr_rows)), [r[0] for r in corr_rows], fontsize=7)
        for i in range(mat.shape[0]):
            for j in range(mat.shape[1]):
                ax.text(j, i, f"{mat[i, j]:+.2f}", ha="center", va="center", fontsize=6)
        save(fig, "parameter_correlation.png")

    return saved


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="generate search-result figures")
    p.add_argument("results_dir")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    for path in generate_figures(args.results_dir, args.out_dir):
        print(path)


if __name__ == "__main__":
    main()
