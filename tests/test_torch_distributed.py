"""Port parity: ``elvis_tpu_torch.parallel.distributed`` (the multi-process
runtime on ``torch.distributed``) against ``elvis_tpu.parallel.distributed``.

One process: initialisation with nothing configured is a no-op, the hybrid
mesh is ``make_mesh``'s, a process-local batch is the batch split over the
data axis. Two processes (subprocesses over ``gloo`` on localhost, each with
4 logical CPU devices, the counterpart of JAX's ``TestTwoProcess``): the
hybrid mesh spans both, process-major on ``data``; each process feeds only
its rows; a cross-process reduction over the shards equals the one over the
concatenated batch (1e-6 relative); unequal local device counts raise.
Each process is killed after 120 s at most.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from elvis_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_initialize_is_a_noop_without_config(monkeypatch):
    from elvis_tpu.parallel.distributed import initialize_distributed as jinit
    from elvis_tpu_torch.parallel.distributed import initialize_distributed, is_distributed

    for var in ("ELVIS_TPU_COORDINATOR", "ELVIS_TPU_NUM_PROCESSES", "ELVIS_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device_type="cpu") is False is jinit()
    assert is_distributed() is False
    monkeypatch.setenv("ELVIS_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(device_type="cpu")


@pytest.mark.parametrize("ici", [(), (("tensor", 2),)])
def test_hybrid_mesh_degenerates_to_make_mesh(monkeypatch, ici):
    from elvis_tpu.parallel.distributed import make_hybrid_mesh as jhybrid
    from elvis_tpu_torch.parallel.distributed import make_hybrid_mesh

    monkeypatch.setattr(tmesh, "devices", lambda device_type="cuda": [CPU] * 8)
    mesh = make_hybrid_mesh(ici_axes=ici, device_type="cpu")
    assert mesh.shape == dict(jhybrid(ici_axes=ici).shape)
    assert mesh.process_index is None


def test_process_local_batch_single_process(monkeypatch):
    from elvis_tpu.parallel.distributed import make_hybrid_mesh as jhybrid
    from elvis_tpu.parallel.distributed import process_local_batch as jlocal
    from elvis_tpu_torch.parallel.distributed import make_hybrid_mesh, process_local_batch

    monkeypatch.setattr(tmesh, "devices", lambda device_type="cuda": [CPU] * 8)
    n = len(jax.devices())
    x = np.arange(n * 4 * 4, dtype=np.float32).reshape(n, 4, 4)
    got = process_local_batch(torch.from_numpy(x), make_hybrid_mesh(device_type="cpu"))
    want = jlocal(x, jhybrid(), "data")
    assert got.shape == tuple(want.shape) == x.shape and len(got.shards) == 8
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="not divisible"):
        process_local_batch(torch.zeros((6, 2)), make_hybrid_mesh(device_type="cpu"))


_WORKER = textwrap.dedent(
    """
    import sys
    import torch
    import torch.distributed as dist
    from elvis_tpu_torch.parallel import mesh as tmesh
    from elvis_tpu_torch.parallel.distributed import (
        initialize_distributed, make_hybrid_mesh, process_local_batch)

    pid, nproc, port, local = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
    tmesh.devices = lambda device_type="cuda": [torch.device("cpu")] * local
    assert initialize_distributed(f"localhost:{port}", nproc, pid, device_type="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
    try:
        mesh = make_hybrid_mesh(ici_axes=(("tensor", 2),), device_type="cpu")
    except ValueError as exc:
        print("UNEQUAL", exc, flush=True)
        dist.destroy_process_group()
        sys.exit(0)
    assert mesh.shape == {"data": 2 * nproc, "tensor": 2}, mesh.shape
    # process-major along data: rows 0-1 are process 0's, rows 2-3 process 1's
    assert mesh.process_index[:, 0].tolist() == [p for p in range(nproc) for _ in range(2)]

    # each process feeds its own frames; the global batch is their concatenation
    x_local = torch.full((4, 8, 8), float(pid + 1))
    x = process_local_batch(x_local, mesh, "data")
    assert x.shape == (4 * nproc, 8, 8) and len(x.shards) == 2
    assert all(s.shape == (2, 8, 8) for s in x.shards)
    total = torch.stack([s.sum() for s in x.shards]).sum()
    dist.all_reduce(total)
    want = sum((p + 1.0) * 4 * 64 for p in range(nproc))
    assert abs(float(total) - want) <= 1e-6 * want, (float(total), want)
    mean = total / (4 * nproc * 64)
    assert abs(float(mean) - sum(p + 1.0 for p in range(nproc)) / nproc) <= 1e-6
    dist.destroy_process_group()
    if pid == 0:
        print("DIST_OK", flush=True)
    """
)


def _run_workers(tmp_path, locals_):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(len(locals_)), port,
                               str(n)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env)
             for i, n in enumerate(locals_)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    return outs


def test_two_processes_global_mesh_and_reduction(tmp_path):
    outs = _run_workers(tmp_path, [4, 4])
    assert "DIST_OK" in outs[0], outs[0][-2000:]


def test_two_processes_with_unequal_local_devices_raise(tmp_path):
    outs = _run_workers(tmp_path, [4, 2])
    assert all("UNEQUAL" in o and "unequal local device counts" in o for o in outs), outs
