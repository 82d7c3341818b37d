"""The port's counterparts of the repository's graft entry points: a
single-device forward check and a multi-device dry run.

  * :func:`entry`: the flagship model's forward step (RRDB ``SRNet`` at 32
    features, growth 16, 2 blocks, 2x super-resolution) and example
    arguments, on the card by default;
  * :func:`dryrun_multichip`: the four parts of the JAX package's dry run on
    ``n`` shards: the DP x TP train step; frame-sharded SR and the haloed
    temporal fill, each held to its unsharded run; the data x spatial tiled
    restore held to the whole frames; a miniature ``run_elvis`` with
    ``data_parallel=True``.

Where the process sees fewer than ``n`` devices of the type (one card, or
the CPU), the shards are logical: the port's device list
(``parallel.mesh.devices``) is replaced by ``n`` copies of the device for
the dry run's span, the counterpart of the JAX package's forced host
device count. Run: ``python -m elvis_tpu_torch.graft_entry [n]``.
"""

from __future__ import annotations

import contextlib
import math
import sys
import tempfile
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from elvis_tpu_torch.device import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device: "str | torch.device" = "cuda"):
    """``(fn, (params, x))``: ``fn(params, x)`` is the forward step of RRDB
    ``SRNet(32, 16, 2)`` under the ``{name: tensor}`` parameters ``params``
    (torch's initialisation, the tail at zero as the flax init), on ``x``
    ``(2, 128, 128, 3)`` zeros, everything on ``device``."""
    from elvis_tpu_torch.models import SRNet

    dev = resolve_device(device)
    model = SRNet(features=32, growth=16, num_blocks=2).to(dev)
    with torch.no_grad():
        model.tail.weight.zero_()
        model.tail.bias.zero_()
    params = {n: p.detach() for n, p in model.named_parameters()}
    x = torch.zeros((2, 128, 128, 3), dtype=torch.float32, device=dev)

    def fn(params, x):
        with torch.no_grad():
            return functional_call(model, params, (x,))

    return fn, (params, x)


@contextlib.contextmanager
def _shards(n: int, dev: torch.device):
    """``n`` devices of ``dev``'s type for the span: the real ones where the
    process has ``n``, else ``n`` logical shards of ``dev``."""
    from elvis_tpu_torch.parallel import mesh as pmesh

    real = pmesh.devices
    if len(real(dev.type)) >= n:
        yield False
        return
    pmesh.devices = lambda device_type="cuda": [dev] * n
    try:
        yield True
    finally:
        pmesh.devices = real


def dryrun_multichip(n_devices: int, device: "str | torch.device" = "cuda") -> Dict:
    """The DP x TP train step of ``SRNet(16, 8, 1)`` on ``n_devices`` shards
    (data n/2 x tensor 2 where n is even), then the sharded inference slice
    held to its unsharded run: frame-sharded progressive SR (max error
    below 1e-3), the window-1 temporal fill through ``temporal_map_overlap``
    with overlap 2 (below 1e-3), the data x spatial height-tiled restore
    with a halo of 4 blocks (below 0.1 grey level), and a ``run_elvis`` of
    8 frames of 64 x 48 with ``data_parallel=True`` (finite foreground PSNR
    above 10 dB on three rows). Raises ``AssertionError`` on a miss; returns
    the readings."""
    from elvis_tpu_torch.degrade import adaptive_downsample, apply_selective_removal, \
        stretch_frames
    from elvis_tpu_torch.models import SRNet
    from elvis_tpu_torch.parallel import make_hybrid_mesh, make_mesh, spatial_tile_map_blocks, \
        temporal_map_overlap
    from elvis_tpu_torch.pipeline import ElvisConfig, run_elvis
    from elvis_tpu_torch.pipeline.run import _DataParallel
    from elvis_tpu_torch.restore import progressive_restore
    from elvis_tpu_torch.restore.inpaint import restore_removal_temporal
    from elvis_tpu_torch.train import Trainer, synthetic_sr_batch

    dev = resolve_device(device)
    out: Dict = {}
    with _shards(n_devices, dev) as logical:
        # Part 1: the full SR training step, DP over the batch x TP over
        # the conv output channels
        tensor = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
        mesh = make_hybrid_mesh(ici_axes=(("tensor", tensor),) if tensor > 1 else (),
                                device_type=dev.type)
        model = SRNet(features=16, growth=8, num_blocks=1).to(dev)

        def loss_fn(p, batch):
            lo, hi = batch
            return torch.mean((functional_call(model, p, (lo,)) - hi) ** 2) / 255.0**2

        trainer = Trainer(loss_fn, model, mesh=mesh, learning_rate=1e-3, device=dev)
        batch = synthetic_sr_batch(torch.Generator(device=dev).manual_seed(1),
                                   batch=n_devices, patch=32)
        loss = float(trainer.step(batch))
        assert math.isfinite(loss), loss
        out.update(mesh=dict(mesh.shape), logical=logical, loss=loss)
        print(f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} loss={loss:.6f} OK")

        # Part 2: degrade -> frame-sharded progressive SR -> haloed
        # temporal fill, each against its unsharded run
        data_mesh = make_mesh(device_type=dev.type)
        n, h, w, b = 2 * n_devices, 32, 48, 8
        rng = np.random.default_rng(0)
        clip = torch.as_tensor((rng.random((n, h, w, 3)) * 255).astype(np.float32), device=dev)
        scores = torch.as_tensor(rng.random((n, h // b, w // b)).astype(np.float32), device=dev)
        degraded, levels = adaptive_downsample(clip, scores, b)

        def sr_fn(f, m):
            return progressive_restore(f, m, b, max_level=3)

        dp = _DataParallel(True, device_type=dev.type)
        sr_err = float((dp.apply(sr_fn, degraded, levels) - sr_fn(degraded, levels)).abs().max())
        assert sr_err < 1e-3, f"sharded SR != unsharded (max err {sr_err})"

        def inp_fn(f, m):
            return restore_removal_temporal(f, m, b, window=1, motion_radius=2)

        shrunk, removal = apply_selective_removal(clip, scores, b, 0.25)
        stretched = stretch_frames(shrunk, removal, b)
        inpainted = temporal_map_overlap(inp_fn, (stretched, removal), data_mesh, overlap=2)
        inp_err = float((inpainted.float() - inp_fn(stretched, removal).float()).abs().max())
        assert inp_err < 1e-3, f"halo inpaint != unsharded (max err {inp_err})"
        out.update(sr_max_err=sr_err, halo_fill_max_err=inp_err)
        print(f"dryrun_multichip({n_devices}): pipeline slice OK (sharded SR "
              f"max_err={sr_err:.2e}, halo inpaint max_err={inp_err:.2e} vs single-device)")

        # Part 3: data x spatial: height tiles with pixel and block halos
        if n_devices % 2 == 0:
            sp = 2 if n_devices == 2 else 4
            mesh2d = make_mesh((("data", n_devices // sp), ("spatial", sp)),
                               device_type=dev.type)
            halo = 4 * b
            h2 = sp * 2 * halo  # tile height 2*halo: the least legal tile
            clip2 = torch.as_tensor((rng.random((n, h2, w, 3)) * 255).astype(np.float32),
                                    device=dev)
            sc2 = torch.as_tensor(rng.random((n, h2 // b, w // b)).astype(np.float32),
                                  device=dev)
            deg2, lev2 = adaptive_downsample(clip2, sc2, b)
            tiled = spatial_tile_map_blocks(sr_fn, deg2, lev2, mesh2d, halo=halo, block_size=b,
                                            data_axis="data")
            err2d = float((tiled - sr_fn(deg2, lev2)).abs().max())
            assert err2d < 0.1, f"2D tiled restore != untiled (max err {err2d})"
            out.update(mesh2d=dict(mesh2d.shape), tiled_max_err=err2d)
            print(f"dryrun_multichip({n_devices}): 2D data x spatial restore OK "
                  f"(mesh={dict(mesh2d.shape)}, max_err={err2d:.2e} vs untiled)")

        # Part 4: a miniature run_elvis over the data mesh
        with tempfile.TemporaryDirectory() as exp_dir:
            results = run_elvis(ElvisConfig(
                reference_video="synthetic://moving?frames=8&fps=24", width=64, height=48,
                block_size=8, experiment_dir=exp_dir, enable_fvmd=False, enable_vmaf=False,
                generate_opencv_benchmarks=False, target_bitrate_override=100_000,
                data_parallel=True), device=dev)
        rows = {}
        for label in ("Baseline", "PRESLEY RealESRGAN", "ELVIS ProPainter"):
            fg = results[label]["foreground"]["psnr_mean"]
            assert np.isfinite(fg) and fg > 10, (label, fg)
            rows[label] = fg
        out["fg_psnr"] = rows
        print(f"dryrun_multichip({n_devices}): full run_elvis on the mesh OK (fg psnr: "
              + ", ".join(f"{k}={v:.2f}" for k, v in rows.items()) + ")")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
