"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are in ``BENCHMARK.json`` and the files it names. Exits
non-zero, with no result line, without enough CUDA devices for the cell or
when a JAX-side module was loaded in this process.
"""

import time

START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".port_bench_cache"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    import torch

    from port_bench.harness import cell, spec

    chips = int(spec.workload(spec.load_benchmark(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           root=ROOT, device="cuda", start_time=START)
    loaded = cell.forbidden_loaded()
    if loaded:
        print(f"port_bench: JAX-side modules loaded in this process: {loaded}", file=sys.stderr)
        return 4
    cell.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
