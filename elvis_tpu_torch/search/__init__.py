"""Search drivers (port of ``elvis_tpu.search``): the grid and random
sweeps over ``run_elvis`` overrides, the results pruner, the
rate-distortion sweep and the figure roll-up."""

from elvis_tpu_torch.search.grid import grid_search, is_valid_overrides, slugify
from elvis_tpu_torch.search.random_search import random_search

__all__ = ["grid_search", "is_valid_overrides", "random_search", "slugify"]
