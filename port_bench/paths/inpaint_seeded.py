"""The client's removal restore through E2FGVI-HQ, which ships no weights: a
player hands each received segment (the kept blocks of every row packed
left, and the removal mask) to ``stretch_frames`` and the inpaint backend
the configuration names, as ``resolve_inpaint_backend(name,
ElvisConfig(inpaint_params_path=file, e2fgvi_*), device)`` returns it, and
waits for the restored uint8 frames.

Inputs: a pool of distinct segments made on the device from the seed (the
restore mixes' content); per segment a smooth removability field drawn from
the seed, from which ``apply_selective_removal`` removes, in every block
row, the ``int(shrink_amount * blocks)`` blocks of highest removability,
with the pipeline's cooldown. Set-up draws the weights of the
configuration's ``arch`` from its ``weights_seed`` (E2FGVI's initialisation
at the scales it lists under ``assumed``) and writes them as a port weights
file in a temporary directory; the reference reads the same file with its
own code. The check runs the plain float32 reference's ``test.py`` loop on
the judged segment's stretched frames and compares the last output the
window produced for it: every pixel outside the holes must equal the
input, and the holes are held to the configuration's limits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.counts import e2fgvi as counts
from port_bench.harness import content
from port_bench.paths.restore import sample, sync
from port_bench.reference.e2fgvi import ReferenceE2FGVI


def seeded_weights(arch: dict, seed: int, assumed: dict) -> dict:
    """``{state-dict name: float32 array}`` drawn in ``counts.param_shapes``
    order from one generator, as E2FGVI's ``init_weights`` starts the
    generator (every conv and linear weight normal, every bias zero,
    LayerNorms at 1 and 0) but at the scales listed under ``assumed``:
    weights of std ``trunk_gain / sqrt(fan_in)`` in place of 0.02; the offset
    head's last conv (zero upstream) at ``offset_head_gain / sqrt(fan_in)``;
    the soft composition's linear at ``soft_comp_gain / sqrt(fan_in)``;
    the deformable convs uniform within ``dcn_gain / sqrt(fan_in)`` (mmcv's
    init at ``dcn_gain`` 1); SPyNet's convs with PyTorch's default init
    (weights and biases uniform within ``1 / sqrt(fan_in)``), the weights
    times ``spynet_gain``; the decoder's last conv at
    ``decoder_last_gain / sqrt(fan_in)``."""
    gen = torch.Generator().manual_seed(int(seed) % (2**63))
    trunk = float(assumed["trunk_gain"])
    out = {}
    for name, shape in counts.param_shapes(arch):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        layer = name.rsplit(".", 1)[0]
        if name.endswith(".bias"):
            if layer.startswith("update_spynet."):
                w_fan = out[layer + ".weight"][0].size
                t = (2 * torch.rand(shape, generator=gen) - 1) / math.sqrt(w_fan)
            else:
                t = torch.zeros(shape)
        elif ".norm" in name:
            t = torch.ones(shape)
        elif layer.startswith("update_spynet."):
            t = (2 * torch.rand(shape, generator=gen) - 1) * (
                float(assumed["spynet_gain"]) / math.sqrt(fan_in))
        elif layer.startswith("feat_prop_module.deform_align.") and layer.count(".") == 2:
            t = (2 * torch.rand(shape, generator=gen) - 1) * (
                float(assumed["dcn_gain"]) / math.sqrt(fan_in))
        else:
            gain = trunk
            if layer.endswith("conv_offset.6"):
                gain = float(assumed["offset_head_gain"])
            elif layer == "sc.embedding":
                gain = float(assumed["soft_comp_gain"])
            elif layer == "decoder.6":
                gain = float(assumed["decoder_last_gain"])
            t = torch.randn(shape, generator=gen) * (gain / math.sqrt(fan_in))
        out[name] = t.numpy().astype(np.float32)
    return out


def write_weights(path: str, layers: dict) -> None:
    """A port weights file: ``params/<layer path>/kernel`` (convs HWIO,
    linears ``(in, out)``), ``/scale`` (LayerNorms) and ``/bias`` float32,
    and ``arch = "e2fgvi_hq"``."""
    arrays = {"arch": np.asarray("e2fgvi_hq")}
    for name, a in layers.items():
        layer, kind = name.rsplit(".", 1)
        prefix = "params/" + layer.replace(".", "/")
        if kind == "bias":
            arrays[prefix + "/bias"] = np.asarray(a, np.float32)
        elif a.ndim == 1:
            arrays[prefix + "/scale"] = np.asarray(a, np.float32)
        else:
            k = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            arrays[prefix + "/kernel"] = np.ascontiguousarray(k, np.float32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def removability(params: dict, n_segments: int, frames: int, by: int, bx: int,
                 gen: torch.Generator, device) -> torch.Tensor:
    """float32 ``(S, N, By, Bx)``: a smooth random field per frame, the
    bilinear resize of ``field_cells`` rows of normal draws, half blended
    into the previous frame's."""
    cells = int(params["field_cells"])
    field = torch.randn((n_segments * frames, 1, cells, max(1, cells * bx // by)),
                        generator=gen, device=device)
    field = F.interpolate(field, size=(by, bx), mode="bilinear", align_corners=False)
    field = field.reshape(n_segments, frames, by, bx)
    return torch.cat([field[:, :1], 0.5 * (field[:, 1:] + field[:, :-1])], dim=1)


def hole_pixels(mask: torch.Tensor, block: int, dilation_px: int) -> torch.Tensor:
    """bool ``(N, H, W)``: the removed blocks as pixels, then every pixel
    within ``dilation_px`` of one in city-block distance inside the frame
    (what ``test.py``'s ``dilation_px`` dilations by a 3x3 cross give): the
    sum of a diamond of ones over the pixels is positive."""
    m = mask.float().repeat_interleave(block, 1).repeat_interleave(block, 2)
    d = int(dilation_px)
    if d > 0:
        r = torch.arange(-d, d + 1, device=m.device)
        diamond = ((r[:, None].abs() + r[None, :].abs()) <= d).float()
        m = F.conv2d(m[:, None], diamond[None, None], padding=d)[:, 0]
    return m > 0


def compare(out: torch.Tensor, ref: torch.Tensor, stretched: torch.Tensor,
            hole: torch.Tensor) -> dict:
    """uint8 ``out`` against ``ref``: pixels outside ``hole`` that differ
    from ``stretched`` (a count), and over the hole pixels the worst frame's
    mean absolute gap and the share of gaps over 4; infinite for another
    shape."""
    if out.shape != ref.shape:
        return {"nonhole_changed": math.inf, "frame_mae_lsb": math.inf, "over4_share": math.inf}
    keep = ~hole[..., None].expand_as(out)
    changed = ((out != stretched) & keep).sum()
    diff = (out.int() - ref.int()).abs().float()
    inside = (~keep).float()
    per_frame = (diff * inside).sum(dim=(1, 2, 3)) / inside.sum(dim=(1, 2, 3)).clamp_min(1)
    return {
        "nonhole_changed": float(changed),
        "frame_mae_lsb": float(per_frame.max()),
        "over4_share": float(((diff > 4) & ~keep).sum() / (~keep).sum().clamp_min(1)),
    }


def _weights_fault(edit):
    """A fault: the program on the configuration's weights with ``edit``
    applied to them (a dict of arrays, in place); the reference keeps the
    sound file."""
    def fault(driver):
        from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

        cfg = driver.run.config
        layers = seeded_weights(cfg["arch"], cfg["weights_seed"], cfg["assumed"])
        edit(layers, cfg["arch"])
        path = driver.weights[:-len(".npz")] + "_fault.npz"
        write_weights(path, layers)
        config = dataclasses.replace(driver.config, inpaint_params_path=path)
        return resolve_inpaint_backend(cfg["inpaint_backend"], config, device=driver.dev)[0]
    return fault


def _zero_offsets(layers, arch):
    # the offset head's 2 * 9 * G offset outputs: offsets are the flow alone
    n = 18 * int(arch["deform_groups"])
    for d in ("backward_", "forward_"):
        pre = f"feat_prop_module.deform_align.{d}.conv_offset.6"
        layers[pre + ".weight"][:n] = 0
        layers[pre + ".bias"][:n] = 0


def _zero_flows(layers, arch):
    # every SPyNet level's last conv: each level adds nothing to a zero flow
    for name in layers:
        if name.startswith("update_spynet.") and ".basic_module.4.conv." in name:
            layers[name][...] = 0


def _drop_second_order(layers, arch):
    # the n-2 features and flow reach neither the deformable conv nor its
    # offsets (inputs: cond_n1, current, cond_n2, flow_n1, flow_n2)
    c = int(arch["channel"]) // 2
    for d in ("backward_", "forward_"):
        pre = f"feat_prop_module.deform_align.{d}"
        layers[pre + ".weight"][:, c:] = 0
        w = layers[pre + ".conv_offset.0.weight"]
        w[:, 2 * c:3 * c] = 0
        w[:, 3 * c + 2:] = 0


def _model_fault(patch):
    """A fault: a fresh program on the sound weights, run under ``patch``
    (a function of the model that returns a context manager)."""
    def fault(driver):
        from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

        cfg = driver.run.config
        fn = resolve_inpaint_backend(cfg["inpaint_backend"], driver.config, device=driver.dev)[0]

        def faulty(f, m, b):
            with patch(fn.net):
                return fn(f, m, b)
        return faulty
    return fault


def _own_frame_attention(model):
    """Every block's attention run one frame at a time: keys from the
    query's own frame only."""
    stack = contextlib.ExitStack()
    for blk in model.transformer:
        attn = blk.attn

        def per_frame(x, pooled, attn=attn):
            return torch.cat([type(attn).forward(attn, x[t:t + 1], pooled[t:t + 1])
                              for t in range(x.shape[0])])
        stack.enter_context(mock.patch.object(attn, "forward", per_frame))
    return stack


def _no_pooled_keys(model):
    """The pooled keys masked out entirely (-1e4 on every one)."""
    from elvis_tpu_torch.models import e2fgvi

    tables = e2fgvi._key_tables

    def masked(h, w, device):
        local, pooled, bias = tables(h, w, device)
        return local, pooled, torch.full_like(bias, -1e4)
    return mock.patch.object(e2fgvi, "_key_tables", masked)


def _neural(driver):
    from elvis_tpu_torch.pipeline import ElvisConfig
    from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

    return resolve_inpaint_backend("neural", ElvisConfig(), device=driver.dev)[0]


# each fault the check must read as not correct: name -> (driver -> backend)
FAULTS = {
    "offsets_zeroed": _weights_fault(_zero_offsets),
    "flows_zeroed": _weights_fault(_zero_flows),
    "second_order_dropped": _weights_fault(_drop_second_order),
    "own_frame_attention": _model_fault(_own_frame_attention),
    "pooled_keys_dropped": _model_fault(_no_pooled_keys),
    "neural_inpaint_net": _neural,
}


class Driver:
    name = "inpaint_seeded"

    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.checks = cfg["checks"][self.name]
        self.dev = run.device
        self.block = int(cfg["block_size"])
        self.frames_per_step = int(cfg["segment_frames"])
        self.shape = (self.frames_per_step, int(cfg["height"]), int(cfg["width"]))
        self.loop = {k: int(cfg["e2fgvi"][k]) for k in ("neighbor_stride", "ref_stride",
                                                         "num_ref", "mask_dilation")}
        self.outputs = {}

    def make_inputs(self, seed: int) -> None:
        from elvis_tpu_torch.degrade.removal import apply_selective_removal

        tr, (n, h, w), b = self.run.traffic, self.shape, self.block
        cfg = self.run.config
        gen = content.generator(seed, self.dev)
        pool = int(tr["pool_segments"])
        src = content.make_segments(tr["content"], pool, n, h, w, gen, self.dev)
        scores = removability(tr["removal"], pool, n, h // b, w // b, gen, self.dev)
        shrunk, masks = zip(*[apply_selective_removal(
            src[s], scores[s], b, float(cfg["shrink_amount"]),
            int(cfg["shrink_removal_cooldown"])) for s in range(pool)])
        self.shrunk, self.masks = torch.stack(shrunk), torch.stack(masks)
        self.outputs = {}

    def setup(self) -> None:
        from elvis_tpu_torch.pipeline import ElvisConfig
        from elvis_tpu_torch.restore.backends import resolve_inpaint_backend

        cfg = self.run.config
        self._tmp = tempfile.TemporaryDirectory(prefix="port_bench_weights_")
        self.weights = os.path.join(self._tmp.name, f"{cfg['inpaint_backend']}.npz")
        write_weights(self.weights, seeded_weights(cfg["arch"], cfg["weights_seed"],
                                                   cfg["assumed"]))
        loop = self.loop
        self.config = ElvisConfig(inpaint_params_path=self.weights,
                                  e2fgvi_neighbor_stride=loop["neighbor_stride"],
                                  e2fgvi_ref_stride=loop["ref_stride"],
                                  e2fgvi_num_ref=loop["num_ref"],
                                  e2fgvi_mask_dilation=loop["mask_dilation"])
        self.backend, prov = resolve_inpaint_backend(cfg["inpaint_backend"], self.config,
                                                     device=self.dev)
        if not prov.startswith(f"{cfg['inpaint_backend']}:"):
            raise RuntimeError(f"{cfg['inpaint_backend']!r} resolved to {prov}")
        self.make_inputs(self.run.seed)
        self.step(0)
        self.outputs = {}

    def stretched(self, i: int) -> torch.Tensor:
        from elvis_tpu_torch.degrade.removal import stretch_frames

        return stretch_frames(self.shrunk[i], self.masks[i], self.block)

    def step(self, k: int) -> None:
        i = k % self.shrunk.shape[0]
        out = self.backend(self.stretched(i), self.masks[i], self.block)
        sync(self.dev)
        self.outputs[i] = out

    def counts(self) -> dict:
        cfg, (n, h, w) = self.run.config, self.shape
        return {
            "flops_per_step": counts.segment_flops(cfg["arch"], self.loop, n, h, w),
            "dcn_bound_s_per_step": counts.segment_dcn_bound_s(cfg["arch"], self.loop, n, h, w,
                                                               self.run.peaks()),
            "conv_bound_s_per_step": counts.segment_conv_bound_s(cfg["arch"], self.loop, n, h, w,
                                                                 self.run.peaks()),
        }

    def pick_judged(self, seed: int) -> None:
        self.outputs = sample(self.outputs, int(self.checks["judged_segments"]), seed)

    def release(self) -> None:
        """Keep the sample to judge, drop the program."""
        self.pick_judged(self.run.seed)
        self.backend = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32") -> ReferenceE2FGVI:
        return ReferenceE2FGVI(self.weights, self.dev, precision)

    def _reference_out(self, net: ReferenceE2FGVI, i: int) -> torch.Tensor:
        loop = self.loop
        hole = hole_pixels(self.masks[i], self.block, loop["mask_dilation"])
        return net.inpaint(self.stretched(i), hole, loop["neighbor_stride"], loop["ref_stride"],
                           loop["num_ref"])

    def readings(self, outputs: dict, ref_net=None) -> dict:
        """The worst gaps over ``outputs`` (pool index -> uint8 segment) from
        the reference's restore of the same inputs."""
        ref_net = ref_net or self.reference()
        got = []
        for i, out in outputs.items():
            hole = hole_pixels(self.masks[i], self.block, self.loop["mask_dilation"])
            got.append(compare(out, self._reference_out(ref_net, i), self.stretched(i), hole))
        return {k: max(r[k] for r in got) for k in got[0]}

    def control_outputs(self, precision: str = "fp8") -> dict:
        """The control in the program's place, on the judged inputs: the
        reference at ``precision``, by default ``fp8``, one precision below
        the configuration's bf16 parts; ``fp32_low`` puts its float32 parts
        a step down instead."""
        net = self.reference(precision)
        return {i: self._reference_out(net, i) for i in self.outputs}

    def fault_outputs(self) -> dict:
        """``{fault: {pool index: output}}``: each of ``FAULTS`` in the
        program's place, on the judged inputs."""
        out = {}
        for name, make in FAULTS.items():
            fn = make(self)
            out[name] = {i: fn(self.stretched(i), self.masks[i], self.block)
                         for i in self.outputs}
        return out

    def check(self) -> list:
        if not self.outputs:
            return [("no_segment_judged", 1.0, 0.0)]
        got = self.readings(self.outputs)
        return [("nonhole_changed", got["nonhole_changed"], 0.0)] + [
            (name, got[name], float(lim)) for name, lim in self.checks["limits"].items()]
