"""The client's whole work on a segment: ``codec.nvc.decode`` of its stream,
then the restore through the SR backend the configuration names.

Inputs, made in set-up: the restore traffic's segments and level maps
(content, smooth level fields, the benchmark's own box degrade, from the
seed), each encoded once by the port's ``nvc.encode`` at the
configuration's QP and GOP; the window cycles through the streams in a
closed loop. The check, on a sample drawn from the seed: the decoded frames
against the reference decoder's reading of the same stream, and the
restored frames against the reference restore of the reference's decoded
frames with the same level maps.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from port_bench.paths import restore
from port_bench.paths.encode import encode_kwargs
from port_bench.reference import nvc as ref_nvc
from port_bench.reference.restore import restore_segment

DECODE_SPAN = "bench.decode"


class Driver(restore.Driver):
    name = "client"

    def __init__(self, run):
        super().__init__(run)
        self.build_dir = run.root / ".port_bench_cache" / "reference"
        self.decode_s = []

    def make_inputs(self, seed: int) -> None:
        super().make_inputs(seed)
        kw = encode_kwargs(self.run.config)
        self.streams = [self.encode(self.frames[s], device=self.dev, **kw)
                        for s in range(self.frames.shape[0])]
        self.frames = None  # the client has the streams only

    def setup(self) -> None:
        from elvis_tpu_torch.codec.nvc import codec as nvc
        from elvis_tpu_torch.pipeline import ElvisConfig
        from elvis_tpu_torch.restore.backends import resolve_sr_backend

        cfg = self.run.config
        self.encode, self.decode = nvc.encode, nvc.decode
        self.make_inputs(self.run.seed)
        self.backend, prov = resolve_sr_backend(cfg["sr_backend"], ElvisConfig(),
                                                device=self.dev)
        if f"[{cfg['sr_tier']}:" not in prov:
            raise RuntimeError(f"{cfg['sr_backend']!r} resolved to {prov}, "
                               f"not the {cfg['sr_tier']} tier")
        self.step(0)
        self.outputs, self.decode_s = {}, []

    def step(self, k: int) -> None:
        i = k % len(self.streams)
        t0 = time.perf_counter()
        with record_function(DECODE_SPAN):
            decoded, _ = self.decode(self.streams[i], device=self.dev)
            restore.sync(self.dev)
        self.decode_s.append(time.perf_counter() - t0)
        out = self.backend(decoded, self.levels[i], self.block)
        restore.sync(self.dev)
        self.outputs[i] = (decoded, out)

    def counts(self) -> dict:
        # the window's decodes only: the traced segments that follow are
        # slowed by the profiler
        self.run.spans["decode_s"] = list(self.decode_s)
        return {}

    def release(self) -> None:
        super().release()
        self.decode = self.encode = None

    def control_outputs(self) -> dict:
        """The reference in the program's place one step below the
        configuration: the decoder's products in TF32, the net's trunk in fp8."""
        net = self.reference("fp8")
        out = {}
        for i in self.outputs:
            dec = ref_nvc.decode(self.streams[i], self.dev, self.build_dir, tf32=True)
            out[i] = (dec, restore_segment(net, dec, self.levels[i], self.block))
        return out

    def readings(self, outputs: dict, ref_net=None) -> dict:
        ref_net = ref_net or self.reference()
        got = []
        for i, (decoded, restored) in outputs.items():
            ref_dec = ref_nvc.decode(self.streams[i], self.dev, self.build_dir)
            dec = restore.compare(decoded, ref_dec)
            r = restore.compare(restored, restore_segment(ref_net, ref_dec, self.levels[i],
                                                          self.block))
            got.append({"decode_mae_lsb": dec["frame_mae_lsb"], **r})
        return restore.worst(got)
