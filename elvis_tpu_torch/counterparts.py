"""The JAX package's public names that the port does not keep at the same
module path.

``COUNTERPARTS`` maps each such name (``module.name`` under ``elvis_tpu``)
to a tuple of the port's names that do its work (``module.name`` under
``elvis_tpu_torch``), or to a string: the reason the port has none.
Every other name in an ``__all__`` of the JAX package has a namesake in
the port's module of the same path (``tests/test_torch_api_audit.py``
holds both).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

__all__ = ["COUNTERPARTS"]

COUNTERPARTS: Dict[str, Union[Tuple[str, ...], str]] = {
    # the TPU kernels: the hand-written CUDA kernels replace them, under
    # names that say so
    "kernels.block_transform.apply_block_matrix_pallas_kron": (
        "kernels.block_transform.apply_block_matrix_cuda",
        "kernels.block_transform.apply_table_to_frames_cuda",
    ),
    "kernels.block_transform.apply_block_matrix_pallas": (
        "kernels.block_transform.apply_block_matrix_batched_cuda",
    ),
    "utils.compile_cache.enable_compilation_cache": (
        "absorbed: it points XLA's persistent compilation cache at a directory; PyTorch "
        "runs eagerly and compiles nothing but the CUDA kernels, which kernels/_build.py "
        "keeps by the hash of their source (the config field compilation_cache is in "
        "pipeline.config.ABSORBED_FIELDS)"
    ),
}
