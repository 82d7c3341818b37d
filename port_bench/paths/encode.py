"""The server's preparation of a segment: the port's scoring
(``spatial_temporal_complexity``, the configured saliency function,
``removability_scores``), ``adaptive_downsample`` (the hand CUDA kernel)
and ``codec.nvc.encode`` at the configuration's QP and GOP, to a complete
stream.

Inputs: a pool of distinct colour source segments made on the device from
the seed, cycled in a closed loop. The check, on a sample of the pool drawn
from the seed: the scores, the levels and the degraded frames against the
plain reference's, and the stream decoded by the reference decoder against
the reference's degraded frames.
"""

from __future__ import annotations

import math
import struct
import sys
import zlib

import torch
from torch.profiler import record_function

from port_bench.counts.block_transform import frame_transform_bytes
from port_bench.harness import content
from port_bench.paths.restore import sample, sync
from port_bench.reference import nvc as ref_nvc
from port_bench.reference import scoring as ref

ENCODE_SPAN = "bench.encode"


def encode_kwargs(cfg: dict) -> dict:
    c = cfg["codec"]
    return dict(qp=int(c["qp"]), gop=int(c["gop"]), me_radius=int(c["me_radius"]),
                me_step=int(c["me_step"]), me_halfpel=bool(c["me_halfpel"]),
                deblock=bool(c["deblock"]), intra_pred=bool(c["intra_pred"]),
                b_frames=bool(c["b_frames"]), multi_ref=bool(c["multi_ref"]),
                framerate=float(cfg["fps"]))


def stream_gap(stream: bytes, want: torch.Tensor, device, build_dir) -> float:
    """The worst frame's mean squared error of the reference decoder's
    reading of ``stream`` from ``want`` (uint8 ``(N, H, W, 3)``); infinite
    where the stream does not decode to that many frames of that size."""
    try:
        got = ref_nvc.decode(stream, device, build_dir)
    except (ValueError, struct.error, zlib.error) as exc:
        print(f"the reference decoder refused the stream: {exc}", file=sys.stderr)
        return math.inf
    if got.shape != want.shape:
        return math.inf
    return float(((got.float() - want.float()) ** 2).mean(dim=(1, 2, 3)).max())


class Driver:
    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.checks = cfg["checks"]["encode"]
        self.dev = run.device
        self.block = int(cfg["block_size"])
        self.frames_per_step = int(cfg["segment_frames"])
        self.shape = (self.frames_per_step, int(cfg["height"]), int(cfg["width"]))
        self.build_dir = run.root / ".port_bench_cache" / "reference"
        self.outputs = {}
        self.score_events = []

    def make_inputs(self, seed: int) -> None:
        tr, (n, h, w) = self.run.traffic, self.shape
        gen = content.generator(seed, self.dev)
        self.src = content.make_segments(tr["content"], int(tr["pool_segments"]), n, h, w, gen,
                                         self.dev)
        self.outputs = {}

    def setup(self) -> None:
        from elvis_tpu_torch.codec.nvc import codec as nvc
        from elvis_tpu_torch.degrade import adaptive_downsample
        from elvis_tpu_torch.scoring import (get_saliency_fn, removability_scores,
                                             saliency_to_block_mask, spatial_temporal_complexity)

        cfg = self.run.config
        saliency_fn = get_saliency_fn(cfg["saliency_backend"])

        def score(frames):
            cx = spatial_temporal_complexity(frames, self.block)
            fg = saliency_to_block_mask(saliency_fn(frames), self.block)
            return removability_scores(cx.SC, cx.TC, fg, alpha=cfg["removability_alpha"],
                                       smoothing_beta=cfg["removability_smoothing_beta"])

        self.score, self.downsample, self.encode = score, adaptive_downsample, nvc.encode
        self.kw = encode_kwargs(cfg)
        self.make_inputs(self.run.seed)
        self.step(0)
        sync(self.dev)
        self.outputs, self.score_events = {}, []

    def step(self, k: int) -> None:
        i = k % self.src.shape[0]
        frames = self.src[i]
        timed = self.dev.type == "cuda"
        if timed:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        scores = self.score(frames)
        if timed:
            ev[1].record()
            self.score_events.append(ev)
        degraded, levels = self.downsample(frames, scores, self.block)
        with record_function(ENCODE_SPAN):
            stream = self.encode(degraded, device=self.dev, **self.kw)
        self.outputs[i] = (scores, levels, degraded, stream)

    def counts(self) -> dict:
        sync(self.dev)
        self.run.spans["score_s"] = [a.elapsed_time(b) / 1e3 for a, b in self.score_events]
        n, h, w = self.shape
        return {"block_transform_bytes": frame_transform_bytes(n, h, w, block=self.block,
                                                               levels=int(math.log2(self.block)) + 1)}

    def pick_judged(self, seed: int) -> None:
        self.outputs = sample(self.outputs, int(self.checks["judged_segments"]), seed)

    def release(self) -> None:
        self.pick_judged(self.run.seed)
        self.score = self.downsample = self.encode = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, i: int, tf32: bool = False):
        cfg = self.run.config
        s = ref.scores(self.src[i], cfg["removability_alpha"], cfg["removability_smoothing_beta"],
                       tf32=tf32)
        lv = ref.levels_of(s)
        return s, lv, ref.degrade(self.src[i], lv, tf32=tf32)

    def control_outputs(self) -> dict:
        """The reference's scoring and degrade in TF32 in the program's place
        (the program's stream kept)."""
        return {i: self._reference(i, tf32=True) + (out[3],) for i, out in self.outputs.items()}

    def fault_outputs(self) -> dict:
        """The stream's faults at the cell's own size, which no precision
        control reaches (the reference has no encoder): the previous pool
        entry's stream in place of this one's (a state left unchanged), and
        16 bytes inverted in the middle of the stream (an answer altered)."""
        def stale(i):
            j = (i - 1) % self.src.shape[0]
            degraded, _ = self.downsample(self.src[j], self.score(self.src[j]), self.block)
            return self.encode(degraded, device=self.dev, **self.kw)

        def altered(stream):
            s = bytearray(stream)
            mid = len(s) // 2
            s[mid:mid + 16] = bytes(255 - x for x in s[mid:mid + 16])
            return bytes(s)

        return {"stale_stream": {i: o[:3] + (stale(i),) for i, o in self.outputs.items()},
                "altered_stream": {i: o[:3] + (altered(o[3]),) for i, o in self.outputs.items()}}

    def readings(self, outputs: dict) -> dict:
        got = []
        for i, (scores, levels, degraded, stream) in outputs.items():
            rs, rl, rd = self._reference(i)
            same = (levels == rl).repeat_interleave(self.block, 1).repeat_interleave(self.block, 2)
            gap = (degraded.int() - rd.int()).abs() * same[..., None]
            # a level may flip where the reference's 3 * score lies within the
            # score limit of a rounding boundary; elsewhere it must agree
            scaled = 3.0 * rs
            edge = (scaled - torch.floor(scaled) - 0.5).abs() <= 3.0 * self.checks["limits"][
                "score_gap"]
            got.append({
                "score_gap": float((scores - rs).abs().max()),
                "level_flip_share": float(((levels != rl) & ~edge).float().mean()),
                "degrade_gap_lsb": float(gap.max()),
                "stream_mse": stream_gap(stream, rd, self.dev, self.build_dir),
            })
        return {k: max(r[k] for r in got) for k in got[0]}

    def check(self) -> list:
        if not self.outputs:
            return [("no_segment_judged", 1.0, 0.0)]
        got = self.readings(self.outputs)
        return [(name, got[name], float(lim))
                for name, lim in self.checks["limits"].items()]
