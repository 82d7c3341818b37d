"""``BENCHMARK.json`` keeps to its contract: keys, names, units, files, and
a reader for every metric of every cell."""

import json
import re

import pytest

from port_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|features"
                    r"|growth|_dim$|_rank$|width|height)")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad, bad
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and not any(WIDTHS.search(k) for k in c["reduced"])
        cfg = spec.config(BENCH, c["name"])
        assert all(k in cfg for k in c["reduced"])


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        spec.traffic(w["traffic"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert m["moves"] in e2e and _line(m["layer"])
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert callable(spec.metric_reader(m["name"]).read)
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.metrics_of(BENCH, w["name"], "per_layer"), w["name"]
