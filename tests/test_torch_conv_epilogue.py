"""The SR nets' conv epilogue (``elvis_tpu_torch.kernels.conv_epilogue``):
the CUDA kernel against its plain version, the nets' fused route against
their plain route, and the dispatch between the two.

Card tests (marker ``gpu``) skip without a CUDA device; this file imports no
JAX, so on a machine with a card and no JAX they run without the repo's
conftest:

    python -m pytest tests/test_torch_conv_epilogue.py -m gpu --noconftest -q

Tolerance: none. The kernel rounds to bf16 at every step where PyTorch's
elementwise kernels do, so kernel and plain version, and the nets' two
routes through the trunk, are bit-equal (the float32 tail after the trunk
has its own kernel and tests, ``tests/test_torch_tail_conv.py``).
"""

import pytest
import torch

from elvis_tpu_torch.kernels import _build
from elvis_tpu_torch.kernels import conv_epilogue as epi
from elvis_tpu_torch.kernels.tail_conv import tail_conv
from elvis_tpu_torch.models import srnet
from elvis_tpu_torch.utils.trace import counters

# (slope, residual scale, outer scale): the forms the nets use, and the
# scale-1 residual (``body_out``'s long skip)
FORMS = {
    "bias": (None, None, None),
    "bias_slope": (0.2, None, None),
    "bias_residual_0.2": (None, 0.2, None),
    "bias_residual_1": (None, 1.0, None),
    "bias_two_residuals": (None, 0.2, 0.2),
}


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


def _nets():
    c = counters()
    return c.get("nets.epilogue.fused", 0), c.get("nets.epilogue.plain", 0)


def _random_net(net):
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in net.parameters():
            fan_in = max(1, p[0].numel()) if p.dim() == 4 else 1
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
    return net


def _operands(shape, form, dev, seed=0):
    slope, scale, outer_scale = FORMS[form]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*s):
        return (torch.randn(s, generator=gen, device=dev) * 2).to(torch.bfloat16)

    y, bias = rand(*shape), rand(shape[-1])
    kw = {"slope": slope}
    if scale is not None:
        kw.update(residual=rand(*shape), scale=scale)
    if outer_scale is not None:
        kw.update(outer=rand(*shape), outer_scale=outer_scale)
    return y, bias, kw


# --- CPU --------------------------------------------------------------------


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, False), (torch.float32, False),
                                        (torch.bfloat16, True)])
def test_cpu_takes_the_plain_route(dtype, grad):
    """On the CPU, in float32 and with gradients the nets run PyTorch's ops:
    one ``epilogue.plain`` per trunk conv, no ``epilogue.fused``, nothing
    built."""
    net = _random_net(srnet.SRNetCompact(8, 2, dtype=dtype))
    x = torch.rand(1, 5, 7, 3) * 255
    fused, plain = _nets()
    with torch.set_grad_enabled(grad):
        out = net(x)
    assert out.shape == (1, 10, 14, 3)
    assert _nets() == (fused, plain + 4)  # head, conv0, conv1, up


def test_rrdb_counts_every_trunk_conv_on_the_cpu():
    net = _random_net(srnet.SRNet(8, 4, 2))
    fused, plain = _nets()
    with torch.inference_mode():
        net(torch.rand(1, 4, 5, 3) * 255, phase_output=True)
    assert _nets() == (fused, plain + 1 + 2 * 2 * 4 + 2)  # head, 2 RRDBs, body_out, up


def test_plain_version_rounds_where_pytorch_does():
    """The plain version is the bias added to a bias-free output, then the
    models' ops in order, each result stored in bf16."""
    y, bias, kw = _operands((2, 3, 5, 12), "bias_two_residuals", torch.device("cpu"))
    got = epi.conv_epilogue(y, bias, **kw)
    t = y + bias
    t = kw["residual"] + 0.2 * t
    want = kw["outer"] + 0.2 * t
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_module_imports_and_cpu_runs_without_nvcc(monkeypatch):
    """Nothing is built at import or on the CPU route; the wrapper refuses a
    CPU tensor before it would build."""
    def no_build(*a, **k):
        raise AssertionError("a kernel build was started")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    net = _random_net(srnet.SRNet(8, 4, 1))
    with torch.inference_mode():
        net(torch.rand(1, 4, 5, 3) * 255)
    y = torch.zeros(1, 2, 3, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        epi.conv_epilogue_cuda(y, torch.zeros(8, dtype=torch.bfloat16))


# --- the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", [(1, 3, 5, 12), (8, 135, 241, 12), (2, 7, 9, 128),
                                   (2, 67, 121, 256), (1, 5, 3, 512)])
def test_kernel_is_bit_equal_to_plain(form, shape):
    """C = 12 (the student's ``up``; 1x3x5x12 leaves a ragged tail of 4
    elements, 8x135x241x12 takes the grid-stride loop twice with the
    channel wrapping inside a vector), 128, 256, 512; odd H and W."""
    dev = _cuda()
    y, bias, kw = _operands(shape, form, dev, seed=sum(shape))
    want = epi.conv_epilogue(y, bias, **kw)
    before = epi.LAUNCHES["conv_epilogue"]
    got = epi.conv_epilogue_cuda(y, bias, **kw)
    torch.cuda.synchronize()
    assert got is y and epi.LAUNCHES["conv_epilogue"] == before + 1
    assert (got.float() - want.float()).abs().max().item() == 0
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("make,convs", [(lambda: srnet.SRNetCompact(256, 6), 8),
                                        (lambda: srnet.SRNet(128, 128, 3), 27)],
                         ids=["compact_256x6", "rrdb_128_128_3"])
@pytest.mark.parametrize("phase", [True, False])
def test_fused_forward_is_bit_equal_to_plain(make, convs, phase, monkeypatch):
    """Inference takes the fused route (one ``epilogue.fused`` per trunk
    conv); with gradients the same net takes the plain route; both give the
    same bits through the trunk, up to the float32 tail's input, phase and
    interleaved. The tail has its own kernel in inference, which sums in
    another order, so the outputs agree to the tail's float32 rounding:
    1e-5 of the sum of the magnitudes of its terms, times 127.5, and 1e-4
    for the rounding of the output's own sum."""
    dev = _cuda()
    net = _random_net(make()).to(dev)
    x = torch.rand(2, 67, 121, 3, generator=torch.Generator().manual_seed(3)).to(dev) * 255
    tails = []  # each call's tail input
    tail = srnet._tail
    monkeypatch.setattr(srnet, "_tail",
                        lambda t, w, b, plain: tails.append(t) or tail(t, w, b, plain))
    fused, plain = _nets()
    with torch.inference_mode():
        got = net(x, phase_output=phase)
    assert _nets() == (fused + convs, plain)
    with torch.enable_grad():
        want = net(x, phase_output=phase).detach()
    assert _nets() == (fused + convs, plain + convs)
    torch.cuda.synchronize()
    fused_in, plain_in = tails
    assert fused_in.dtype == torch.bfloat16 and torch.equal(fused_in, plain_in.detach())
    with torch.no_grad():
        mag = tail_conv(plain_in.abs(), net.tail.weight.abs(), net.tail.bias.abs())
    assert bool(((got - want).abs() <= 127.5 * 1e-5 * mag + 1e-4).all())


@pytest.mark.gpu
def test_float32_trunk_on_the_card_takes_the_plain_route():
    dev = _cuda()
    net = _random_net(srnet.SRNetCompact(16, 2, dtype=torch.float32)).to(dev)
    fused, plain = _nets()
    with torch.inference_mode():
        net(torch.rand(1, 9, 11, 3, device=dev) * 255)
    assert _nets() == (fused, plain + 4)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["float32", "cpu", "non_contiguous", "misaligned",
                                   "residual_shape", "outer_alone", "channels_over_limit"])
def test_wrapper_refuses(fault):
    """Each fault raises before or at the launch (C above the kernel's 2048
    is refused by the kernel's entry point); nothing is launched."""
    dev = _cuda()
    shape = (2, 5, 7, 16)
    y = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    bias = torch.zeros(16, dtype=torch.bfloat16, device=dev)
    kw = {}
    if fault == "channels_over_limit":
        y = torch.zeros((1, 1, 1, 2056), dtype=torch.bfloat16, device=dev)
        bias = torch.zeros(2056, dtype=torch.bfloat16, device=dev)
    elif fault == "float32":
        y = y.float()
    elif fault == "cpu":
        y = y.cpu()
    elif fault == "non_contiguous":
        y = torch.zeros((2, 7, 5, 16), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    elif fault == "misaligned":
        y = torch.zeros(2 * 5 * 7 * 16 + 1, dtype=torch.bfloat16, device=dev)[1:].view(shape)
    elif fault == "residual_shape":
        kw["residual"] = torch.zeros((2, 5, 7, 8), dtype=torch.bfloat16, device=dev)
    else:
        kw["outer"] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    before = epi.LAUNCHES["conv_epilogue"]
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        epi.conv_epilogue_cuda(y, bias, **kw)
    assert epi.LAUNCHES["conv_epilogue"] == before


def test_fused_share_reader(monkeypatch):
    """``epilogue_fused_share.restore`` reads the ``nets`` counters: None
    where the program counted no trunk conv (as on a program without the
    counters), else fused over all, in %."""
    from port_bench.harness import spec
    from elvis_tpu_torch.utils import trace

    reader = spec.metric_reader("epilogue_fused_share.restore")
    monkeypatch.setattr(trace, "_COUNTERS", {})
    assert reader.read(None) is None
    trace.counter("nets").update({"epilogue.fused": 3, "epilogue.plain": 1})
    assert reader.read(None) == 75.0
