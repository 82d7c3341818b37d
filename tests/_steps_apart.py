"""The card-against-CPU statistic for the bf16 student's training steps,
shared by ``tests/test_torch_gpu.py`` (which applies it on the card) and
``tests/test_torch_smoke_gates.py`` (which holds it on CPU tensors).

A tensor fails when more of its elements than the larger of
``BF16_LEAST`` and ``BF16_SHARE`` of them moved apart by more than the
limit.
"""

BF16_LEAST = 2
BF16_SHARE = 0.05


def tensors_moved_apart(got, want, limit):
    """Two parameter dicts: per tensor, the elements farther apart than
    ``limit``, and the names of the tensors where more are than the larger
    of ``BF16_LEAST`` and ``BF16_SHARE`` of the tensor's elements. A share
    alone cannot be resolved on a small tensor (one element of a 12-element
    bias is 8%): the floor of two elements lets a near-zero gradient or two
    round apart, not a tensor that moved wrongly."""
    beyond = {n: int(((got[n] - want[n]).abs() > limit).sum()) for n in want}
    failing = sorted(n for n, c in beyond.items()
                     if c > max(BF16_LEAST, BF16_SHARE * want[n].numel()))
    return beyond, failing
