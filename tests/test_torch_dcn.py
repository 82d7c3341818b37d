"""The modulated deformable conv (``kernels/dcn.py``) on the CPU: its plain
version against the reference's independent per-tap gather
(``tests/_ref_e2fgvi.py``'s ``deform_conv``, NCHW, mmcv's layout), with
offsets that leave the frame and land on its edges; the column order and the
packed weight; bf16 columns are the float32 ones rounded once; the kernel's
entry point refuses what it cannot take. The kernel itself runs in the
card tests (``tests/test_torch_gpu.py -m gpu``)."""

import pytest
import torch

from elvis_tpu_torch.kernels import dcn

from _ref_e2fgvi import deform_conv


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(n, h, w, c, groups, spread, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=gen)
    offset = torch.randn((n, h, w, 18 * groups), generator=gen) * spread
    mask = torch.rand((n, h, w, 9 * groups), generator=gen)
    weight = torch.randn((24, c, 3, 3), generator=gen) / (9 * c) ** 0.5
    bias = torch.randn((24,), generator=gen)
    return x, offset, mask, weight, bias


def _reference(x, offset, mask, weight, bias, groups):
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    return torch.cat([deform_conv(nchw(x[i:i + 1]), nchw(offset[i:i + 1]), nchw(mask[i:i + 1]),
                                  weight, bias, groups)
                      for i in range(x.shape[0])]).permute(0, 2, 3, 1)


@pytest.mark.parametrize("n,h,w,c,groups,spread", [
    (2, 9, 13, 32, 4, 3.0),    # offsets that leave the frame
    (1, 7, 11, 64, 16, 0.7),   # E2FGVI's 16 groups, mostly inside
    (1, 5, 6, 16, 2, 8.0),     # most taps outside: zero columns
])
def test_plain_matches_the_reference_gather(n, h, w, c, groups, spread):
    x, offset, mask, weight, bias = _case(n, h, w, c, groups, spread, seed=h * w + c)
    got = dcn.modulated_deform_conv(x, offset, mask, weight, bias, groups)
    want = _reference(x, offset, mask, weight, bias, groups)
    assert got.shape == (n, h, w, 24)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_edges_of_the_frame():
    """Positions at -1 and H (nothing sampled), just inside them (one
    corner), and on whole pixels (the sample itself)."""
    h, w, c, groups = 4, 5, 8, 1
    x = torch.arange(h * w * c, dtype=torch.float32).reshape(1, h, w, c) + 1
    mask = torch.ones((1, h, w, 9))
    weight = torch.randn((3, c, 3, 3))
    bias = torch.zeros(3)
    for dy, dx in ((-1.0, 0.0), (0.0, -1.0), (h + 0.0, 0.0), (-0.5, 0.25), (0.0, 0.0),
                   (1.0, 2.0), (-1.0 + 1e-6, 0.0), (float(h) - 1e-3, 3.5)):
        offset = torch.zeros((1, h, w, 18))
        offset[..., 0::2], offset[..., 1::2] = dy, dx
        got = dcn.modulated_deform_conv(x, offset, mask, weight, bias, groups)
        want = _reference(x, offset, mask, weight, bias, groups)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-6, (dy, dx)
    # whole-pixel offsets of 0: the columns are the 3x3 neighbourhood, zero padded
    cols = dcn.deform_columns(x, torch.zeros((1, h, w, 18)), mask, 1)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for k in range(9):
        ky, kx = divmod(k, 3)
        assert torch.equal(cols[..., k * c:(k + 1) * c], padded[:, ky:ky + h, kx:kx + w])


def test_column_order_and_packed_weight():
    """Column ``(g, k, c)`` at ``(9 g + k) * C/G + c``; the packed weight's
    row of the same index holds ``weight[:, g * C/G + c, k // 3, k % 3]``."""
    groups, cg, co = 4, 8, 5
    weight = torch.randn((co, groups * cg, 3, 3))
    packed = dcn.pack_weight(weight, groups)
    assert packed.shape == (9 * groups * cg, co)
    for g, k, c in ((0, 0, 0), (1, 4, 3), (3, 8, 7), (2, 5, 1)):
        assert torch.equal(packed[(9 * g + k) * cg + c], weight[:, g * cg + c, k // 3, k % 3])


def test_bf16_columns_are_the_float32_ones_rounded_once():
    x, offset, mask, _, _ = _case(2, 6, 9, 32, 4, 2.0, seed=7)
    xb = x.to(torch.bfloat16)
    got = dcn.deform_columns(xb, offset, mask, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, dcn.deform_columns(xb.float(), offset, mask, 4).to(torch.bfloat16))


def test_the_kernel_entry_refuses_what_it_cannot_take():
    x, offset, mask, _, _ = _case(1, 4, 4, 16, 2, 1.0, seed=3)
    with pytest.raises(TypeError, match="bf16"):
        dcn.deform_columns_cuda(x, offset, mask, 2)
    with pytest.raises(ValueError, match="CUDA"):
        dcn.deform_columns_cuda(x.to(torch.bfloat16), offset, mask, 2)
    with pytest.raises(ValueError, match="offset must be"):
        dcn.deform_columns(x, offset[..., :-2], mask, 2)
    with pytest.raises(ValueError, match="deform groups"):
        dcn.deform_columns(x, offset, mask, 3)
