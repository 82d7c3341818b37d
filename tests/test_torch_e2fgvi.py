"""E2FGVI-HQ (``models/e2fgvi.py``, the ``e2fgvi_hq`` inpaint backend) on
the CPU, every width as published, on the benchmark configuration's seeded
weights: the float32 generator against the plain reference
``tests/_ref_e2fgvi.py`` at a size with 2x2 attention windows (so the rolled
and pooled keys reach other windows and the pool's padding), all 8 blocks
and 16 deform groups; bf16 within its rounding; ``test.py``'s loop over 12
frames (a reference frame in two windows) against the reference's, and its
averaging by hand; the mirror pad, crop and composite; the weights file;
``run_elvis``'s removal branch; the spans and counters; the benchmark's FLOP
count against the operations the model launches."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from elvis_tpu_torch.models import e2fgvi as E
from elvis_tpu_torch.models.io import load_e2fgvi
from elvis_tpu_torch.pipeline.config import ElvisConfig
from elvis_tpu_torch.restore import backends
from elvis_tpu_torch.utils.trace import counter

from port_bench.counts import e2fgvi as counts
from port_bench.harness import content
from port_bench.paths.inpaint_seeded import seeded_weights, write_weights

from _ref_e2fgvi import ReferenceE2FGVI

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "port_bench/configs/e2fgvi_hq_1080p.json").read_text())
ARCH = CONFIG["arch"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("e2fgvi") / "e2fgvi_hq.npz")
    write_weights(path, seeded_weights(ARCH, CONFIG["weights_seed"], CONFIG["assumed"]))
    return path


@pytest.fixture(scope="module")
def reference(weights):
    return ReferenceE2FGVI(weights, "cpu")


def _clip(n, h, w, seed=1):
    traffic = json.loads((ROOT / "port_bench/traffic/segments_1080p_removal_seeded.json")
                         .read_text())
    gen = content.generator(seed, "cpu")
    frames = content.make_segments(traffic["content"], 1, n, h, w, gen, "cpu")[0]
    hole = torch.zeros((n, h, w), dtype=torch.bool)
    for t in range(n):  # a moving 16x24 hole and a fixed 8x8 one
        hole[t, 8 + 2 * t:24 + 2 * t, 16 + 3 * t:40 + 3 * t] = True
        hole[t, h - 16:h - 8, w - 16:w - 8] = True
    return frames, hole


def _masked(frames, hole):
    x = (frames.float() / 255 * 2 - 1) * (1 - hole[..., None].float())
    return E.mirror_pad(x)


def test_float32_generator_matches_the_reference(weights, reference):
    frames, hole = _clip(4, 120, 216)
    x = _masked(frames, hole)  # tokens 10x18: 2x2 windows
    model = load_e2fgvi(weights, "cpu", torch.float32)
    with torch.inference_mode():
        got = model(x, 3)  # three local frames, one reference
    want = reference.forward_frames(x.permute(0, 3, 1, 2), 3).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (4, 120, 216, 3)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert want.std().item() > 0.2  # the seeded net does not sit on a constant


def test_bf16_within_its_rounding(weights, reference):
    frames, hole = _clip(4, 60, 108)
    x = _masked(frames, hole)
    model = load_e2fgvi(weights, "cpu")
    assert model.encoder.layers[0].weight.dtype == torch.bfloat16
    assert model.update_spynet.basic_module[0].basic_module[0].conv.weight.dtype == torch.float32
    with torch.inference_mode():
        got = model(x, 4)
    want = reference.forward_frames(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)
    gap = (got - want).abs()
    assert gap.mean().item() < 0.02 and gap.max().item() < 0.25, (gap.mean(), gap.max())


def test_the_loop_matches_the_reference_on_12_frames(weights, reference):
    """Windows around frames 0, 5, 10 (frame 10 a reference of the first,
    frame 0 of the last); the bf16 program within the cell's kind of gap."""
    frames, hole = _clip(12, 56, 96)
    model = load_e2fgvi(weights, "cpu")
    with torch.inference_mode():
        got = E.inpaint_video(model, frames, hole, 5, 10, -1)
    want = reference.inpaint(frames, hole, 5, 10, -1)
    assert got.dtype == torch.uint8 and got.shape == frames.shape
    assert torch.equal(got[~hole], frames[~hole])
    gap = (got.int() - want.int()).abs().float()[hole]
    assert gap.mean().item() < 3.0, gap.mean()


def test_loop_windows_references_and_running_average():
    """A stub generator that returns one value a call in every pixel:
    windows 0-5, 0-10 and 5-11; frame 5 lies in all three and keeps 0.25 a
    + 0.25 b + 0.5 c; the prediction is truncated to uint8 before the
    average and the average truncated at the end."""
    calls = []

    def stub(x, num_local):
        calls.append((x.shape[0], num_local))
        value = [-0.9, 0.1, 0.7][len(calls) - 1]
        return torch.full(x.shape, value)

    n, h, w = 12, 8, 12
    frames = torch.full((n, h, w, 3), 9, dtype=torch.uint8)
    hole = torch.zeros((n, h, w), dtype=torch.bool)
    hole[:, 2:4, 3:5] = True
    out = E.inpaint_video(stub, frames, hole, 5, 10, -1)
    assert calls == [(7, 6), (11, 11), (8, 7)]  # refs: 10 for f=0, 0 for f=10
    px = [int((v + 1) / 2 * 255) for v in (-0.9, 0.1, 0.7)]  # 12, 140, 216
    want = {0: 0.5 * px[0] + 0.5 * px[1], 4: 0.5 * px[0] + 0.5 * px[1],
            5: 0.25 * px[0] + 0.25 * px[1] + 0.5 * px[2], 6: 0.5 * px[1] + 0.5 * px[2],
            11: px[2]}
    for t, v in want.items():
        assert int(out[t, 2, 3, 0]) == int(v), t
    assert torch.equal(out[~hole], frames[~hole])
    assert E.reference_ids(20, list(range(15, 26)), 40, 10, 2) == [10, 30]
    assert E.reference_ids(20, list(range(15, 26)), 40, 10, -1) == [0, 10, 30]


def test_mirror_pad_crop_and_composite():
    x = torch.arange(2 * 61 * 110 * 1, dtype=torch.float32).reshape(2, 61, 110, 1)
    y = E.mirror_pad(x)
    assert y.shape == (2, 120, 216, 1)
    assert torch.equal(y[:, :61, :110], x)
    assert torch.equal(y[:, 61:120, :110], torch.flip(x, [1])[:, :59])
    assert torch.equal(y[:, :61, 110:], torch.flip(x, [2])[:, :, :106])
    assert E.mirror_pad(torch.zeros(1, 60, 108, 3)).shape == (1, 60, 108, 3)


def test_hole_dilation_is_test_pys_cross_in_pixels():
    """``dilate_hole`` is ``cv2.dilate`` with a 3x3 cross, ``iterations``
    times: a pixel grows to the diamond of city-block radius ``iterations``,
    cut at the frame's edge, as the benchmark's ``hole_pixels`` (a sum of
    a diamond of ones) has it; 0 leaves the hole as it is."""
    from port_bench.paths.inpaint_seeded import hole_pixels

    hole = torch.zeros((2, 21, 23), dtype=torch.bool)
    hole[0, 10, 11] = True
    hole[1, 0, 22] = True
    got = E.dilate_hole(hole, 4)
    yy, xx = torch.meshgrid(torch.arange(21), torch.arange(23), indexing="ij")
    assert torch.equal(got[0], (yy - 10).abs() + (xx - 11).abs() <= 4)
    assert torch.equal(got[1], yy + (22 - xx) <= 4)
    assert int(got[0].sum()) == 41 and int(got[1].sum()) == 15
    assert torch.equal(E.dilate_hole(hole, 0), hole)
    mask = (torch.rand((3, 6, 9), generator=torch.Generator().manual_seed(4)) < 0.3).to(torch.int8)
    blocks = mask.bool().repeat_interleave(8, 1).repeat_interleave(8, 2)
    for d in (0, 3, 4, 9):
        assert torch.equal(E.dilate_hole(blocks, d), hole_pixels(mask, 8, d)), d


def test_weights_file_and_a_wrong_one(weights, tmp_path):
    model = load_e2fgvi(weights, "cpu", torch.float32)
    names = [name for name, _ in counts.param_shapes(ARCH)]
    assert sorted(model.state_dict()) == sorted(names)
    state = dict(np.load(weights))
    assert state["params/transformer/3/attn/qkv/kernel"].shape == (512, 1536)
    assert state["params/feat_prop_module/deform_align/forward_/kernel"].shape == (3, 3, 256, 128)
    assert state["params/transformer/7/norm2/scale"].shape == (512,)
    w = seeded_weights(ARCH, CONFIG["weights_seed"], CONFIG["assumed"])["encoder.layers.12.weight"]
    assert torch.equal(model.encoder.layers[12].weight, torch.from_numpy(w))
    with pytest.raises(ValueError, match="not E2FGVI-HQ"):
        load_e2fgvi(str(ROOT / "elvis_tpu_torch/weights/inpaint.npz"), "cpu")
    with pytest.raises(ValueError, match="not E2FGVI-HQ"):
        backends.resolve_inpaint_backend(
            "e2fgvi_hq", ElvisConfig(inpaint_params_path=str(
                ROOT / "elvis_tpu_torch/weights/srnet_student.npz")), device="cpu")


def test_backend_pins_the_file_and_falls_back_without_one(weights):
    frames, hole = _clip(6, 48, 64)
    mask = hole[:, ::8, ::8].to(torch.int8)  # whole blocks
    fn, prov = backends.resolve_inpaint_backend(
        "e2fgvi_hq", ElvisConfig(inpaint_params_path=weights), device="cpu")
    assert prov.startswith(f"e2fgvi_hq:{weights}[neighbor_stride=5,ref_stride=10,num_ref=-1")
    assert isinstance(fn.net, E.E2FGVIHQ) and fn.temporal_overlap == 20
    out = fn(frames, mask, 8)
    blocks = mask.bool().repeat_interleave(8, 1).repeat_interleave(8, 2)
    hole = E.dilate_hole(blocks, 4)  # e2fgvi_mask_dilation's default, in pixels
    assert torch.equal(out[~hole], frames[~hole])
    assert not torch.equal(out[hole & ~blocks], frames[hole & ~blocks])
    with torch.inference_mode():
        want = E.inpaint_video(fn.net, frames, hole, 5, 10, -1)
    assert torch.equal(out, want)
    _, prov = backends.resolve_inpaint_backend("e2fgvi_hq", ElvisConfig(), device="cpu")
    assert prov.startswith("temporal+pde (no e2fgvi_hq checkpoint)")
    _, prov = backends.resolve_inpaint_backend("neural", ElvisConfig(), device="cpu")
    assert prov.startswith("inpaint_net:")  # 'neural' stays InpaintNet


def test_run_elvis_removal_branch(weights, tmp_path):
    from elvis_tpu_torch.pipeline.run import run_elvis

    cfg = ElvisConfig(reference_video="synthetic://moving?frames=4&fps=30", width=64,
                      height=48, enable_vmaf=False, enable_fvmd=False,
                      target_bitrate_override=100_000, inpaint_backends=["e2fgvi_hq"],
                      sr_backends=["lanczos"], deblur_backends=["unsharp"],
                      generate_opencv_benchmarks=False, inpaint_params_path=weights,
                      experiment_dir=str(tmp_path / "exp"), verbose=False)
    before = counter("nets")["e2fgvi.forwards"]
    results = run_elvis(cfg, device="cpu")
    assert counter("nets")["e2fgvi.forwards"] == before + 1  # 4 frames: one window
    prov = results["parameters"]["derived"]["backends"]["ELVIS e2fgvi_hq"]
    assert prov.startswith(f"e2fgvi_hq:{weights}"), prov


def test_spans_and_counters(weights):
    frames, hole = _clip(2, 60, 108)
    model = load_e2fgvi(weights, "cpu")
    nets = counter("nets")
    before = dict(nets)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model(_masked(frames, hole), 2)
    names = {e.key for e in prof.key_averages()}
    for span in ("e2fgvi.flow", "e2fgvi.encoder", "e2fgvi.propagation", "e2fgvi.dcn",
                 "e2fgvi.transformer", "e2fgvi.attention", "e2fgvi.ffn", "e2fgvi.decoder"):
        assert span in names, span
    grew = {k: nets[k] - before.get(k, 0) for k in ("e2fgvi.forwards", "e2fgvi.frames",
                                                     "dcn.calls", "epilogue.plain",
                                                     "ffn.plain", "ffn.fused")}
    # a deformable step a direction; the encoder's 9 trunk convs, 4 offset convs a
    # step, the backbone pair a frame and direction, fusion, bias conv, decoder's 3;
    # a feed-forward a block
    assert grew == {"e2fgvi.forwards": 1, "e2fgvi.frames": 2, "dcn.calls": 2,
                    "epilogue.plain": 9 + 2 * 4 + 2 * 2 * 2 + 1 + 1 + 3,
                    "ffn.plain": E.DEPTH, "ffn.fused": 0}, grew


def test_benchmark_flop_count_equals_the_operations_run(weights, monkeypatch):
    """``port_bench/counts/e2fgvi.py`` against the convolutions, linears,
    deformable GEMMs and attention products the model launches, counted
    from their operands' shapes."""
    seen = []
    conv2d, conv_t, linear = F.conv2d, F.conv_transpose2d, F.linear
    addmm, sdpa = torch.addmm, F.scaled_dot_product_attention

    def c2(x, w, *a, **kw):
        out = conv2d(x, w, *a, **kw)
        seen.append(2 * w[0].numel() * out.numel())
        return out

    def ct(x, w, *a, **kw):
        if x.shape[1] > 1:  # not the fold of the linear's bias
            seen.append(2 * w[0].numel() * x.numel())
        return conv_t(x, w, *a, **kw)

    def li(x, w, *a, **kw):
        out = linear(x, w, *a, **kw)
        seen.append(2 * w.shape[1] * out.numel())
        return out

    def mm(b, m1, m2, **kw):
        seen.append(2 * m1.shape[0] * m1.shape[1] * m2.shape[1])
        return addmm(b, m1, m2, **kw)

    def at(q, k, v, **kw):
        seen.append(2 * 2 * q.numel() * k.shape[-2])
        return sdpa(q, k, v, **kw)

    for mod, name, fn in ((F, "conv2d", c2), (F, "conv_transpose2d", ct), (F, "linear", li),
                          (torch, "addmm", mm), (F, "scaled_dot_product_attention", at)):
        monkeypatch.setattr(mod, name, fn)
    frames, hole = _clip(5, 120, 108)
    model = load_e2fgvi(weights, "cpu")
    with torch.inference_mode():
        model(_masked(frames, hole), 4)
    parts = counts.forward_flops(ARCH, 5, 4, 120, 108)
    assert sum(seen) == sum(v for k, v in parts.items() if k not in ("dcn", "attention"))
    # the cell's segment: forwards over 6 and 8 frames at 1080x1944
    loop = {"neighbor_stride": 5, "ref_stride": 10, "num_ref": -1}
    assert counts.windows(8, 5, 10, -1) == [(6, 6), (8, 8)]
    total = counts.segment_flops(ARCH, loop, 8, 1080, 1920)
    assert total == sum(sum(v for k, v in counts.forward_flops(ARCH, t, t, 1080, 1944).items()
                            if k not in ("dcn", "attention")) for t in (6, 8))
    assert 40e12 < total < 70e12


def test_conv_bound_counts_every_convolution_run(weights, monkeypatch):
    """``counts.conv_calls`` against the convolutions the model launches (the
    soft split's and the soft composition's, the fold of its bias and the
    float32 tail's included; the deformable GEMM is no convolution), call
    for call in FLOPs; and the bound's sum over the cell's segment."""
    seen = []
    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def c2(x, w, *a, **kw):
        out = conv2d(x, w, *a, **kw)
        seen.append(2 * w[0].numel() * out.numel())
        return out

    def ct(x, w, *a, **kw):
        seen.append(2 * w[0].numel() * x.numel())
        return conv_t(x, w, *a, **kw)

    monkeypatch.setattr(F, "conv2d", c2)
    monkeypatch.setattr(F, "conv_transpose2d", ct)
    frames, hole = _clip(5, 120, 108)
    model = load_e2fgvi(weights, "cpu")
    with torch.inference_mode():
        model(_masked(frames, hole), 4)
    calls = counts.conv_calls(ARCH, 5, 4, 120, 108)
    # SPyNet's 30 convs and the offset stack run batched as listed
    assert sorted(seen) == sorted(f for f, _, _ in calls), (len(seen), len(calls))
    peaks = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    loop = {"neighbor_stride": 5, "ref_stride": 10, "num_ref": -1}
    bound = counts.segment_conv_bound_s(ARCH, loop, 8, 1080, 1920, peaks)
    assert bound == sum(max(f / peaks[p], b / 3.35e12)
                        for t in (6, 8) for f, b, p in counts.conv_calls(ARCH, t, t, 1080, 1944))
    assert 0.05 < bound < 0.12, bound
