"""The client's restore: a player hands each decoded, block-degraded segment
and its level maps to the SR backend the configuration names, as
``resolve_sr_backend(name, ElvisConfig(), device)`` returns it, and waits
for the restored uint8 frames.

Inputs: a pool of distinct segments made on the device from the seed
(content, smooth level fields, each block degraded by the benchmark's own
box resample), cycled in a closed loop. The check runs the plain float32
reference over a sample of the pool drawn from the seed, on the last output
the window produced for each.
"""

from __future__ import annotations

import math
import random

import torch

from port_bench.counts import srnet as counts
from port_bench.harness import content
from port_bench.reference.restore import restore_segment
from port_bench.reference.srnet import ReferenceSR


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The gaps of uint8 ``out`` from uint8 ``ref``, both ``(N, H, W, 3)``;
    infinite where ``out`` has another shape."""
    if out.shape != ref.shape:
        return {"frame_mae_lsb": math.inf, "over4_share": math.inf}
    diff = (out.int() - ref.int()).abs()
    return {
        "frame_mae_lsb": float(diff.float().mean(dim=(1, 2, 3)).max()),
        "over4_share": float((diff > 4).float().mean()),
    }


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}


def sample(outputs: dict, k: int, seed: int) -> dict:
    """``k`` of the finished pool entries' outputs, drawn from ``seed``."""
    done = sorted(outputs)
    return {i: outputs[i] for i in sorted(random.Random(seed).sample(done, min(k, len(done))))}


class Driver:
    name = "restore"

    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.checks = cfg["checks"][self.name]
        self.dev = run.device
        self.block = int(cfg["block_size"])
        self.frames_per_step = int(cfg["segment_frames"])
        self.shape = (self.frames_per_step, int(cfg["height"]), int(cfg["width"]))
        self.outputs = {}

    def make_inputs(self, seed: int) -> None:
        tr, (n, h, w), b = self.run.traffic, self.shape, self.block
        gen = content.generator(seed, self.dev)
        pool = int(tr["pool_segments"])
        src = content.make_segments(tr["content"], pool, n, h, w, gen, self.dev)
        self.levels = content.make_levels(tr["levels"], pool, n, h // b, w // b, gen, self.dev)
        self.frames = torch.stack([content.degrade(src[s], self.levels[s], b)
                                   for s in range(pool)])
        self.outputs = {}

    def setup(self) -> None:
        from elvis_tpu_torch.pipeline import ElvisConfig
        from elvis_tpu_torch.restore.backends import resolve_sr_backend

        cfg = self.run.config
        self.make_inputs(self.run.seed)
        self.backend, prov = resolve_sr_backend(cfg["sr_backend"], ElvisConfig(),
                                                device=self.dev)
        if f"[{cfg['sr_tier']}:" not in prov:
            raise RuntimeError(f"{cfg['sr_backend']!r} resolved to {prov}, "
                               f"not the {cfg['sr_tier']} tier")
        self.backend(self.frames[0], self.levels[0], self.block)
        sync(self.dev)

    def step(self, k: int) -> None:
        i = k % self.frames.shape[0]
        out = self.backend(self.frames[i], self.levels[i], self.block)
        sync(self.dev)
        self.outputs[i] = out

    def counts(self) -> dict:
        cfg, (n, h, w) = self.run.config, self.shape
        max_level = int(self.levels.max())
        return {
            "flops_per_step": counts.segment_flops(cfg["arch"], n, h, w, max_level),
            "conv_bound_s_per_step": counts.segment_conv_bound_s(cfg["arch"], n, h, w, max_level,
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

    def reference(self, precision: str = "fp32") -> ReferenceSR:
        return ReferenceSR(str(self.run.root / self.run.config["weights"]), self.dev, precision)

    def readings(self, outputs: dict, ref_net=None) -> dict:
        """The worst gaps over ``outputs`` (pool index -> uint8 segment) from
        the reference's restore of the same inputs."""
        ref_net = ref_net or self.reference()
        return worst([compare(out, restore_segment(ref_net, self.frames[i], self.levels[i],
                                                   self.block))
                      for i, out in outputs.items()])

    def control_outputs(self) -> dict:
        """The control in the program's place: the reference with an fp8
        trunk, on the judged inputs."""
        net = self.reference("fp8")
        return {i: restore_segment(net, self.frames[i], self.levels[i], self.block)
                for i in self.outputs}

    def check(self) -> list:
        if not self.outputs:
            return [("no_segment_judged", 1.0, 0.0)]
        got = self.readings(self.outputs)
        return [(name, got[name], float(lim)) for name, lim in self.checks["limits"].items()]
