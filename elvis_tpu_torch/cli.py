"""CLI entry point: ``python -m elvis_tpu_torch.cli [--config cfg.json] [--flags]``.

Every ``ElvisConfig`` field is a flag, plus ``--config`` JSON, merged
defaults -> file -> flags. The pipeline runs on the CUDA card (it raises
when there is none).
"""

from __future__ import annotations

import sys

from elvis_tpu_torch.pipeline import load_config_from_cli, run_elvis


def main(argv=None) -> int:
    config = load_config_from_cli(argv)
    run_elvis(config, device="cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
