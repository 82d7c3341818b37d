"""The card-against-CPU statistic for the bf16 student's steps
(``tensors_moved_apart``, ``tests/_steps_apart.py``; the ``-m gpu`` test
``test_bf16_student_steps_on_the_card_match_the_cpu`` applies it), on CPU
tensors.

A tensor fails when more of its elements than the larger of 2 and 5% of
them moved apart by more than the limit.
"""

import pytest
import torch

from _steps_apart import tensors_moved_apart

LIMIT = 0.25 * 2 * 1e-4  # a quarter of two steps' summed learning rate


def _params(gen):
    """A step's result: a 12-element bias and a 1000-element kernel, and
    the same moved by a whole step (2e-4) everywhere."""
    start = {"up.bias": torch.randn(12, generator=gen), "conv0.weight": torch.randn(
        (10, 4, 5, 5), generator=gen)}
    moved = {k: v + 2e-4 * torch.sign(torch.randn(v.shape, generator=gen)) for k, v in
             start.items()}
    return start, moved


@pytest.mark.parametrize("case,failing", [
    ("one of 12 apart", []),
    ("two of 12 apart", []),
    ("12-element tensor unmoved", ["up.bias"]),
    ("6% of 1000 apart", ["conv0.weight"]),
    ("5% of 1000 apart", []),
])
def test_tensors_moved_apart(case, failing):
    start, want = _params(torch.Generator().manual_seed(0))
    got = {k: v.clone() for k, v in want.items()}
    if case == "one of 12 apart":
        got["up.bias"][3] = start["up.bias"][3]
    elif case == "two of 12 apart":
        got["up.bias"][:2] = start["up.bias"][:2]
    elif case == "12-element tensor unmoved":
        got["up.bias"] = start["up.bias"].clone()
    else:
        count = 60 if case.startswith("6%") else 50
        got["conv0.weight"].view(-1)[:count] = start["conv0.weight"].view(-1)[:count]
    beyond, names = tensors_moved_apart(got, want, LIMIT)
    assert names == failing
    moved = {"one of 12 apart": 1, "two of 12 apart": 2, "12-element tensor unmoved": 12,
             "6% of 1000 apart": 60, "5% of 1000 apart": 50}[case]
    assert sum(beyond.values()) == moved
