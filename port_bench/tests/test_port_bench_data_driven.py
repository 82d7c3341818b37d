"""A new configuration, traffic mix and metric are files and entries only:
the harness lists the new cell and reads the new metric without an edit to
a file that is already there."""

import json
import shutil

from port_bench.harness import cell, spec

from conftest import SMALL


def test_new_cell_and_metric_from_files_alone(tmp_path):
    shutil.copytree(spec.ROOT / spec.BENCH_DIR, tmp_path / spec.BENCH_DIR,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "elvis_tpu_torch").symlink_to(spec.ROOT / "elvis_tpu_torch")  # the program
    before = {p: p.read_bytes() for p in (tmp_path / spec.BENCH_DIR).rglob("*") if p.is_file()}
    bench = spec.load_benchmark()
    # the files a later change would add
    base = spec.config(bench, "elvis_student_1080p")
    cfg = dict(base, name="elvis_student_720p", width=1280, height=720)
    (tmp_path / spec.BENCH_DIR / "configs" / "elvis_student_720p.json").write_text(json.dumps(cfg))
    mix = spec.traffic("segments_1080p_restore")
    mix["pool_segments"] = 2
    (tmp_path / spec.BENCH_DIR / "traffic" / "segments_720p_restore.json").write_text(
        json.dumps(mix))
    (tmp_path / spec.BENCH_DIR / "metrics" / "restore_frames.py").write_text(
        '"""Frames restored in the window."""\n\n\ndef read(run):\n    return run.frames\n')
    # ... and the entries
    bench["configs"].append({"name": "elvis_student_720p", "source": base["source"],
                             "file": "port_bench/configs/elvis_student_720p.json",
                             "reduced": ["segment_frames"], "why": "a test's configuration"})
    bench["workloads"].append({"name": "student_720p_restore", "config": "elvis_student_720p",
                               "traffic": "segments_720p_restore", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "restore_frames", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "nets", "moves": "restore_fps",
                               "workloads": ["student_720p_restore"]})
    for m in bench["end_to_end"]:
        if m["name"] == "restore_fps":
            m["workloads"].append("student_720p_restore")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    assert "student_720p_restore" in spec.cell_names(tmp_path)
    names = [m["name"] for m in spec.metrics_of(bench, "student_720p_restore", "per_layer")]
    assert names == ["restore_frames"]
    result = cell.run_cell("student_720p_restore", 3, 0.5, True, root=tmp_path, device="cpu",
                           overrides=SMALL)
    assert result["correct"]
    assert result["metrics"]["restore_frames"]["value"] > 0
    assert result["metrics"]["restore_frames"]["unit"] == "frames"
    after = {p: p.read_bytes() for p in before}
    assert after == before
