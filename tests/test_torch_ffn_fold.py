"""E2FGVI-HQ's feed-forward fold (``elvis_tpu_torch.kernels.ffn_fold``): the
plain version against the chain ``FusionFeedForward`` ran inline before it,
bit for bit, at the e2fgvi_hq cell's token grid and at small odd ones; the
kernel wrapper's refusals; the feed-forward's route, counters and span on
the CPU; on the card (marker ``gpu``) the kernel bit-equal to the plain
version at the cell's two frame counts and at small odd grids, two calls
bit-equal, and the feed-forward's fused route counting one launch a call.

This file imports no JAX, so on a machine with a card and no JAX its card
tests run without the repo's conftest:

    python -m pytest tests/test_torch_ffn_fold.py -m gpu --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elvis_tpu_torch.kernels import ffn_fold as ff
from elvis_tpu_torch.models import e2fgvi as E
from elvis_tpu_torch.utils.trace import counter

CELL = (270, 486)  # the cell's map at a quarter of 1080x1944: 90 x 162 tokens
SMALL = [(10, 19), (13, 25), (12, 21), (3, 4)]  # 4x7, 5x9, 4x7 and 1x2 tokens


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inline_chain(h, th, tw, output_size, dtype):
    """``FusionFeedForward.forward``'s ops between fc1 and fc2 as they stood
    before the kernel: fc1's output reshaped, cast and transposed, folded,
    normalised, unfolded, GELU, cast."""
    t = h.shape[0]
    x = h.reshape(t, th * tw, -1).float().transpose(1, 2)
    fold = dict(output_size=output_size, kernel_size=7, padding=3, stride=3)
    ones = torch.ones((1, 7 * 7, th * tw), dtype=torch.float32, device=h.device)
    x = F.fold(x, **fold) / F.fold(ones, **fold)
    x = F.unfold(x, kernel_size=7, padding=3, stride=3).transpose(1, 2)
    return F.gelu(x).to(dtype)


def _tokens(n, output_size, dtype=torch.bfloat16, seed=0, device="cpu"):
    th, tw = ff.token_grid(output_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((n, th * tw, E.FFN_HIDDEN), generator=gen, device=device) * 0.7
    return h.to(dtype), th, tw


def test_token_grid():
    assert ff.token_grid(CELL) == (90, 162)
    assert [ff.token_grid(s) for s in SMALL] == [(4, 7), (5, 9), (4, 7), (1, 2)]


@pytest.mark.parametrize("output_size,dtype", [(CELL, torch.bfloat16)]
                         + [(s, d) for s in SMALL for d in (torch.bfloat16, torch.float32)])
def test_plain_is_the_inline_chain_bit_for_bit(output_size, dtype):
    n = 1 if output_size == CELL else 3
    h, th, tw = _tokens(n, output_size, dtype, seed=sum(output_size))
    got = ff.ffn_fold_gelu(h, th, tw, output_size)
    want = _inline_chain(h, th, tw, output_size, dtype)
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got, want)


def test_plain_normalises_by_the_patch_count():
    """Tokens all equal to 2: every pixel's fold is twice its count, so after
    the division every value is gelu(2), and 0 where the patch leaves the map."""
    th, tw = ff.token_grid((10, 19))
    h = torch.full((1, th * tw, E.FFN_HIDDEN), 2.0)
    got = ff.ffn_fold_gelu(h, th, tw, (10, 19)).reshape(th, tw, 40, 7, 7)
    inner = got[1:-1, 1:-1].unique()
    assert inner.numel() == 1 and abs(float(inner) - float(F.gelu(torch.tensor(2.0)))) < 1e-6
    assert torch.equal(got[0, :, :, :3], torch.zeros_like(got[0, :, :, :3]))  # rows above the map
    assert torch.equal(got[:, 0, :, :, :3], torch.zeros_like(got[:, 0, :, :, :3]))


def test_kernel_wrapper_refuses_what_it_cannot_take():
    h, th, tw = _tokens(1, (10, 19))
    with pytest.raises(ValueError, match="CUDA"):
        ff.ffn_fold_gelu_cuda(h, th, tw, (10, 19))
    with pytest.raises(TypeError, match="bf16"):
        ff.ffn_fold_gelu_cuda(h.float(), th, tw, (10, 19))
    strided = h.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ff.ffn_fold_gelu_cuda(strided, th, tw, (10, 19))
    with pytest.raises(ValueError, match="tile"):
        ff.ffn_fold_gelu_cuda(h, th, tw, (13, 25))
    with pytest.raises(ValueError, match="must be"):
        ff.ffn_fold_gelu_cuda(h[..., :-49], th, tw, (10, 19))


def _ffn(dtype, device="cpu", seed=3):
    gen = torch.Generator().manual_seed(seed)
    ffn = E.FusionFeedForward()
    with torch.no_grad():
        for p in ffn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1, p.shape[-1]) ** 0.5)
    return ffn.to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feed_forward_takes_the_plain_route_on_the_cpu(dtype):
    """On the CPU the feed-forward counts ``nets.ffn.plain`` once a call,
    launches nothing, records its span, and equals fc1, the inline chain
    and fc2."""
    ffn = _ffn(dtype)
    y = torch.randn((2, 4, 7, E.HIDDEN), generator=torch.Generator().manual_seed(4)).to(dtype)
    nets = counter("nets")
    before = (nets["ffn.plain"], nets["ffn.fused"], ff.LAUNCHES["ffn_fold"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            got = ffn(y, (10, 19))
    assert (nets["ffn.plain"], nets["ffn.fused"], ff.LAUNCHES["ffn_fold"]) == (
        before[0] + 1, before[1], before[2])
    assert "e2fgvi.ffn" in {e.key for e in prof.key_averages()}
    fc1, fc2 = ffn.conv1[0], ffn.conv2[1]
    with torch.inference_mode():
        h = F.linear(y, fc1.weight, fc1.bias)
        want = F.linear(_inline_chain(h, 4, 7, (10, 19), dtype), fc2.weight, fc2.bias)
    assert torch.equal(got, want.reshape(2, 4, 7, E.HIDDEN))


@pytest.mark.gpu
@pytest.mark.parametrize("n,output_size", [(6, CELL), (8, CELL), (3, (13, 25)), (2, (52, 61)),
                                           (1, (3, 4))],
                         ids=["cell_6", "cell_8", "5x9", "18x21", "1x2"])
def test_kernel_is_the_plain_version_bit_for_bit(n, output_size):
    """The cell's two forwards (6 and 8 frames of 90x162 tokens) and odd
    grids that cut the kernel's strips and row chunks: bit-equal to the plain
    version on the card, two calls bit-equal, one launch a call."""
    dev = _cuda()
    h, th, tw = _tokens(n, output_size, seed=n + sum(output_size), device=dev)
    before = ff.LAUNCHES["ffn_fold"]
    got = ff.ffn_fold_gelu_cuda(h, th, tw, output_size)
    again = ff.ffn_fold_gelu_cuda(h, th, tw, output_size)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["ffn_fold"] == before + 2
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    want = ff.ffn_fold_gelu(h, th, tw, output_size)
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_feed_forward_fuses_in_bf16_inference_on_the_card():
    """In bf16 inference on the card the feed-forward counts ``ffn.fused``
    and one launch a call, and equals fc1, the plain version and fc2 on the
    kernel's bits; with gradients it takes the plain route."""
    dev = _cuda()
    ffn = _ffn(torch.bfloat16, dev)
    y = torch.randn((3, 5, 9, E.HIDDEN), device=dev).to(torch.bfloat16)
    nets = counter("nets")
    before = (nets["ffn.fused"], nets["ffn.plain"], ff.LAUNCHES["ffn_fold"])
    with torch.inference_mode():
        got = ffn(y, (13, 25))
    assert (nets["ffn.fused"], nets["ffn.plain"], ff.LAUNCHES["ffn_fold"]) == (
        before[0] + 1, before[1], before[2] + 1)
    fc1, fc2 = ffn.conv1[0], ffn.conv2[1]
    with torch.inference_mode():
        h = F.linear(y, fc1.weight, fc1.bias).reshape(3, 45, -1)
        want = F.linear(ff.ffn_fold_gelu(h, 5, 9, (13, 25)).contiguous(), fc2.weight, fc2.bias)
    assert torch.equal(got, want.reshape(got.shape))
    with torch.enable_grad():
        ffn(y, (13, 25))
    assert (nets["ffn.fused"], nets["ffn.plain"]) == (before[0] + 1, before[1] + 1)
