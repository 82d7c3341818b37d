"""The command: no result and a non-zero exit without the CUDA devices a
cell asks for, and in a directory that holds only ``BENCHMARK.json`` and
the benchmark's files; a short run on the card (marked)."""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import spec

ARGS = ["--workload", "student_1080p_restore", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_result_without_a_card(tmp_path):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(spec.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_with_the_benchmark_files_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in spec.load_benchmark()["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_short_run_on_the_card(cuda):
    out = _run(spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"restore_fps", "restore_p95_ms", "setup_s"}
    assert list(result)[-1] == "checks"
