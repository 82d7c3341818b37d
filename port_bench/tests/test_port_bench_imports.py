"""The import guard: nothing the benchmark imports is JAX-side. Module
names are compared by their whole top-level name (``elvis_tpu_torch``
passes, ``elvis_tpu`` does not)."""

import ast
import subprocess
import sys

from port_bench.harness import cell, spec

FORBIDDEN = set(cell.FORBIDDEN_MODULES)
BENCH_DIR = spec.ROOT / spec.BENCH_DIR


def _sources():
    return [p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def test_no_source_of_the_benchmark_names_a_jax_side_module():
    found = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            found += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found, found


def test_the_benchmark_and_what_it_loads_bring_in_no_jax_side_module():
    """Import every module of the benchmark and the port's entries it
    drives, in a fresh process, then look at ``sys.modules``."""
    mods = ["port_bench.run", "port_bench.calibrate"]
    mods += [".".join(p.relative_to(spec.ROOT).with_suffix("").parts) for p in _sources()
             if p.parent.name in ("harness", "reference", "counts", "paths")]
    code = "\n".join([
        "import sys, importlib",
        f"sys.path.insert(0, {str(spec.ROOT)!r})",
        *[f"importlib.import_module({m!r})" for m in mods],
        "from port_bench.harness import spec",
        "for m in spec.load_benchmark()['per_layer'] + spec.load_benchmark()['end_to_end']:",
        "    spec.metric_reader(m['name'])",
        "import elvis_tpu_torch.restore.backends, elvis_tpu_torch.codec.nvc.codec",
        "import elvis_tpu_torch.degrade, elvis_tpu_torch.scoring, elvis_tpu_torch.pipeline",
        "print(sorted({m.split('.')[0] for m in sys.modules}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "elvis_tpu_torch" in loaded and "port_bench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_loaded_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "elvis_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert "elvis_tpu" not in cell.forbidden_loaded()
    assert "jax" not in cell.forbidden_loaded() or "jax" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "elvis_tpu.codec", object())
    assert "elvis_tpu" in cell.forbidden_loaded()
