"""The SR nets' float32 tail (``elvis_tpu_torch.kernels.tail_conv``): the
plain version against the nets' own tail routes and a float64 conv, the
wrapper's refusals, the nets' routing and its counters and span; on the
card (marker ``gpu``) the kernel against the plain version at small odd
shapes on both of its kernels (whole pixel records for Cin 16 to 128,
channel planes otherwise), and the nets' fused tail against their plain
route.

This file imports no JAX, so on a machine with a card and no JAX its card
tests run without the repo's conftest:

    python -m pytest tests/test_torch_tail_conv.py -m gpu --noconftest -q

Tolerance: the plain version, the nets' phase route (a conv over the phase
tensor with the scattered 4 Cin -> 12 kernel) and the kernel all sum the
same float32 products in other orders, so each output is held within
``TOL`` times the sum of the magnitudes of its terms (about 80 float32
epsilons of that sum; the expected gap is well under one).
"""

import json

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elvis_tpu_torch.kernels import _build
from elvis_tpu_torch.kernels import tail_conv as tc
from elvis_tpu_torch.models import srnet
from elvis_tpu_torch.ops.resize import deinterleave_phases, interleave_phases
from elvis_tpu_torch.utils.trace import counters

TOL = 1e-5


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


def _tails():
    c = counters()
    return c.get("nets.tail.fused", 0), c.get("nets.tail.plain", 0)


def _operands(shape, cin, seed=0, device="cpu", cout=3):
    """A bf16 input of ``shape`` (its last axis ``cin``), a float32 weight
    ``(cout, cin, 3, 3)`` at fan-in scale and a float32 bias."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 2).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3), generator=gen) / (9 * cin) ** 0.5
    b = torch.randn((cout,), generator=gen)
    return x.to(device), w.to(device), b.to(device)


def _reference(x, w, b):
    """float64 conv of the same input over the full-resolution image, in
    ``x``'s geometry, and the sum of its terms' magnitudes."""
    phase = x.dim() == 6
    full = (interleave_phases(x) if phase else x).double().permute(0, 3, 1, 2)
    out = F.conv2d(full, w.double(), b.double(), padding=1).permute(0, 2, 3, 1)
    mag = F.conv2d(full.abs(), w.double().abs(), b.double().abs(), padding=1).permute(0, 2, 3, 1)
    if phase:
        out, mag = deinterleave_phases(out), deinterleave_phases(mag)
    return out, mag


def _held(got, want, mag):
    assert got.dtype == torch.float32 and got.shape == want.shape
    gap = (got.double() - want).abs()
    assert bool((gap <= TOL * mag + 1e-30).all()), gap.max().item()


def _tail_module(w, b):
    tail = srnet._TailConv(cin=w.shape[1])
    with torch.no_grad():
        tail.weight.copy_(w)
        tail.bias.copy_(b)
    return tail


# --- CPU --------------------------------------------------------------------


GEOMETRIES = {"phase": lambda cin: (2, 5, 7, 2, 2, cin), "direct": lambda cin: (2, 9, 13, cin)}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("cin", [3, 64, 128])
def test_plain_version_equals_the_nets_tail(geometry, cin):
    """Odd H and W: the plain version against ``_TailConv.phase`` (the
    scattered phase-domain kernel ``k4``) or ``_TailConv.forward``, and both
    against a float64 conv, to float32 rounding."""
    x, w, b = _operands(GEOMETRIES[geometry](cin), cin, seed=cin)
    tail = _tail_module(w, b)
    with torch.no_grad():
        got = tc.tail_conv(x, w, b)
        net = tail.phase(x) if geometry == "phase" else tail(x)
    want, mag = _reference(x, w, b)
    _held(got, want, mag)
    _held(net, want, mag)
    assert got.shape == x.shape[:-1] + (3,)


def test_plain_phase_is_the_direct_conv_interleaved():
    x, w, b = _operands((1, 3, 4, 2, 2, 16), 16, seed=2)
    got = tc.tail_conv(x, w, b)
    assert torch.equal(interleave_phases(got), tc.tail_conv(interleave_phases(x), w, b))


def test_pack_weight_layout():
    _, w, _ = _operands((1, 1, 1, 5), 5, seed=4)
    packed = tc.pack_weight(w)
    assert packed.shape == (8, 28) and packed.dtype == torch.float32  # Cin 5, padded to 8
    assert packed.is_contiguous()
    for c in range(5):
        for ky in range(3):
            for kx in range(3):
                for o in range(3):
                    assert packed[c, (ky * 3 + kx) * 3 + o] == w[o, c, ky, kx]
    assert not packed[:, 27].any() and not packed[5:].any()


def test_packed_weight_is_reused_until_the_weight_changes():
    _, w, _ = _operands((1, 1, 1, 8), 8, seed=5)
    first = tc._packed(w)
    assert tc._packed(w) is first
    w.mul_(2)  # a new version of the same storage
    second = tc._packed(w)
    assert second is not first and torch.equal(second, tc.pack_weight(w))
    with torch.inference_mode():
        frozen = w.clone()  # an inference tensor keeps no version: packed each call
    assert tc._packed(frozen) is not tc._packed(frozen)


FAULTS = {  # name -> (what to change, error, message)
    "cpu": ({}, ValueError, "CUDA"),
    "float32_input": ({"x": lambda x: x.float()}, TypeError, "bf16"),
    "bad_rank": ({"x": lambda x: x.reshape(2, 5, 7, 4, 8)}, ValueError, "must be"),
    "bad_phase_axes": ({"x": lambda x: x.reshape(2, 5, 7, 1, 4, 8)}, ValueError, "must be"),
    "non_contiguous": ({"x": lambda x: x.transpose(1, 2)}, ValueError, "contiguous"),
    "four_outputs": ({"w": lambda w: torch.cat([w, w[:1]])}, ValueError, "3 output"),
    "weight_channels": ({"w": lambda w: w[:, :4].contiguous()}, ValueError, "weight must"),
    "bias_shape": ({"b": lambda b: b[:2]}, ValueError, "bias"),
    "bf16_weight": ({"w": lambda w: w.to(torch.bfloat16)}, TypeError, "float32"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_wrapper_refuses(fault, monkeypatch):
    """Each fault raises its documented error before anything is built or
    launched (here on CPU tensors: the device is checked last, so each
    fault shows on its own)."""
    def no_build(*a, **k):
        raise AssertionError("a kernel build was started")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    x, w, b = _operands((2, 5, 7, 2, 2, 8), 8, seed=6)
    change, error, message = FAULTS[fault]
    args = {"x": x, "w": w, "b": b}
    for key, fn in change.items():
        args[key] = fn(args[key])
    before = tc.LAUNCHES["tail_conv"]
    with pytest.raises(error, match=message):
        tc.tail_conv_cuda(args["x"], args["w"], args["b"])
    assert tc.LAUNCHES["tail_conv"] == before


def _span_names(fn, tmp_path):
    """The program's spans of a CPU profile of ``fn``, as ``[(name, start,
    end)]``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


NETS = {
    "compact": lambda: srnet.SRNetCompact(8, 2),
    "rrdb": lambda: srnet.SRNet(8, 4, 1),
    "realesrgan": lambda: srnet.RealESRGANx2(num_feat=8, num_grow_ch=4, num_block=1),
}


@pytest.mark.parametrize("name", list(NETS))
def test_cpu_nets_take_the_plain_tail_under_its_span(name, tmp_path):
    """On the CPU, in bf16 inference, every net runs its tail as written:
    one ``tail.plain`` a call, no ``tail.fused``, inside an ``srnet.tail``
    span (in ``RealESRGANx2`` inside ``srnet.upsample_head``)."""
    net = NETS[name]()
    x = torch.rand(1, 5, 6, 3) * 255
    fused, plain = _tails()
    with torch.inference_mode():
        spans = _span_names(lambda: net(x), tmp_path)
    assert _tails() == (fused, plain + 1)
    tails = [s for s in spans if s[0] == "srnet.tail"]
    assert len(tails) == 1
    if name == "realesrgan":
        heads = [s for s in spans if s[0] == "srnet.upsample_head"]
        assert any(h[1] <= tails[0][1] and tails[0][2] <= h[2] for h in heads)


def test_fused_share_reader(monkeypatch):
    """``tail_fused_share.restore`` reads the ``nets`` tail counters: None
    where the program counted no tail (as on a program without them), else
    fused over all, in %."""
    from port_bench.harness import spec
    from elvis_tpu_torch.utils import trace

    reader = spec.metric_reader("tail_fused_share.restore")
    monkeypatch.setattr(trace, "_COUNTERS", {})
    assert reader.read(None) is None
    trace.counter("nets").update({"epilogue.fused": 9})
    assert reader.read(None) is None
    trace.counter("nets").update({"tail.fused": 3, "tail.plain": 1})
    assert reader.read(None) == 75.0


# --- the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 9, 70, 2, 2, 128), (1, 5, 3, 64), (2, 17, 131, 64),
                                   (1, 7, 9, 2, 2, 16), (2, 5, 40, 32), (1, 3, 5, 2, 2, 3),
                                   (1, 7, 9, 2, 2, 12), (3, 33, 257, 24)],
                         ids=["rrdb_phase", "tiny_direct", "realesrgan_direct", "phase_16",
                              "direct_32", "student_phase", "phase_12", "direct_24"])
def test_kernel_matches_plain(shape):
    """Odd H and W, tiles cut at the right and bottom edges; Cin 16 to 128
    (the records kernel, one lane a channel pair, idle lanes past Cin) and
    Cin 3, 12 and 24 (the planar kernel, one to six chunks of 4)."""
    dev = _cuda()
    x, w, b = _operands(shape, shape[-1], seed=sum(shape), device=dev)
    before = tc.LAUNCHES["tail_conv"]
    got = tc.tail_conv_cuda(x, w, b)
    torch.cuda.synchronize()
    assert tc.LAUNCHES["tail_conv"] == before + 1
    want, mag = _reference(x, w, b)
    _held(got, want, mag)
    _held(tc.tail_conv(x, w, b), want, mag)


@pytest.mark.gpu
def test_phase_interleaved_is_the_direct_kernel_bit_for_bit():
    dev = _cuda()
    x, w, b = _operands((2, 11, 37, 2, 2, 32), 32, seed=8, device=dev)
    got = tc.tail_conv_cuda(x, w, b)
    direct = tc.tail_conv_cuda(interleave_phases(x), w, b)
    torch.cuda.synchronize()
    assert torch.equal(interleave_phases(got), direct)


@pytest.mark.gpu
def test_misaligned_input_takes_the_narrow_chunks():
    """An input 16-byte misaligned (a view one element in) runs on the planar
    kernel's chunks of 4 read one by one: the same values to float32
    rounding."""
    dev = _cuda()
    x, w, b = _operands((1, 6, 10, 2, 2, 16), 16, seed=9, device=dev)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    got = tc.tail_conv_cuda(shifted, w, b)
    want, mag = _reference(x, w, b)
    _held(got, want, mag)


OUTPUT_SCALE = {"compact": 127.5, "rrdb": 127.5, "realesrgan": 255.0}  # the tail's, in the output


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NETS))
def test_nets_fused_tail_matches_their_plain_route(name, monkeypatch):
    """In bf16 inference on the card every net's tail takes the kernel (one
    ``tail.fused`` a call, one launch); with gradients the same net takes
    its plain route, on the same bits (the trunk is bit-equal); the outputs
    agree to ``TOL`` of the sum of the magnitudes of the tail's terms, times
    the tail's scale in the output, and 1e-4 for the output's own
    rounding."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(11)
    net = NETS[name]().to(dev)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1, p[0].numel()) ** 0.5)
    x = torch.rand(2, 33, 47, 3, generator=gen).to(dev) * 255
    tails = []  # each call's tail operands
    tail = srnet._tail
    monkeypatch.setattr(srnet, "_tail",
                        lambda t, w, b, plain: tails.append((t, w, b)) or tail(t, w, b, plain))
    fused, plain = _tails()
    before = tc.LAUNCHES["tail_conv"]
    with torch.inference_mode():
        got = net(x)
    assert _tails() == (fused + 1, plain) and tc.LAUNCHES["tail_conv"] == before + 1
    with torch.enable_grad():
        want = net(x).detach()
    assert _tails() == (fused + 1, plain + 1)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 66, 94, 3)
    (fused_in, _, _), (plain_in, w, b) = tails
    assert fused_in.dtype == torch.bfloat16 and torch.equal(fused_in, plain_in.detach())
    with torch.no_grad():
        mag = tc.tail_conv(plain_in.abs(), w.abs(), b.abs())[:, :66, :94]
    assert bool(((got - want).abs() <= OUTPUT_SCALE[name] * TOL * mag + 1e-4).all())
