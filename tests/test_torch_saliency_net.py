"""Port parity: the neural saliency backend (``elvis_tpu_torch.models.saliency_net``
and the ``'neural'`` registration of ``elvis_tpu_torch.scoring.saliency``)
against ``elvis_tpu.models.saliency_net`` / ``elvis_tpu.scoring.saliency``,
with the shipped weights, on the same numpy frames, on the CPU.

Tolerances: in float32 the saliency within 1e-5 at a size whose quarter
is odd (36x44: the stride-2 levels give 18x22 and 9x11) and one whose
quarter is even (64x96); measured 6.1e-7. In bf16 (the shipped dtype)
both packages round every conv's output to bf16 and their convs sum in
another order: the largest difference measured here is 0.00257 (pinned at
0.005), and the block masks agree on every block (pinned at 99.5%).
Chunked scoring reads one halo frame a side, so its features equal the
unchunked ones exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

BF16_MAX_ABS = 0.005
MASK_AGREE = 0.995


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jparams():
    from elvis_tpu.models import SaliencyNet
    from elvis_tpu.models.io import default_checkpoint_dir, load_params

    return load_params(SaliencyNet(), f"{default_checkpoint_dir()}/saliency",
                       np.zeros((2, 16, 16, 3), np.float32))


def _clip(n, h, w, seed=0):
    """A textured background with a bright square moving 3 px a frame."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, h, w, 3)) * 80 + 40).astype(np.float32)
    for i in range(n):
        frames[i, h // 4: h // 4 + h // 3, 3 * i + 4: 3 * i + 4 + w // 3] = [230, 200, 60]
    return np.round(frames).astype(np.uint8)


def _port(dtype):
    from elvis_tpu_torch.models.io import load_saliency, weights_path

    net = load_saliency(weights_path("saliency"), device="cpu")
    net.dtype = dtype
    return net


@pytest.mark.parametrize("hw", [(36, 44), (64, 96)])
def test_saliency_net_float32_matches_jax(jparams, hw):
    from elvis_tpu.models import SaliencyNet

    frames = _clip(4, *hw)
    want = np.asarray(SaliencyNet(dtype=jnp.float32).apply(jparams, jnp.asarray(frames,
                                                                                 jnp.float32)))
    with torch.inference_mode():
        got = _port(torch.float32)(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (4,) + hw and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert want.max() - want.min() > 0.5  # the net separates the square


def test_saliency_net_bf16_matches_jax(jparams):
    from elvis_tpu.models import SaliencyNet
    from elvis_tpu.scoring.saliency import saliency_to_block_mask as jmask
    from elvis_tpu_torch.scoring.saliency import saliency_to_block_mask as tmask

    frames = _clip(6, 64, 96, seed=1)
    want = np.asarray(SaliencyNet().apply(jparams, jnp.asarray(frames, jnp.float32)))
    with torch.inference_mode():
        got = _port(torch.bfloat16)(torch.from_numpy(frames))
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_MAX_ABS, err
    agree = (tmask(got, 8).numpy() == np.asarray(jmask(jnp.asarray(want), 8))).mean()
    assert agree >= MASK_AGREE, agree


def test_neural_registration_matches_jax():
    """'neural' loads the shipped net once per device and runs it in bf16,
    as the JAX package's registration does."""
    from elvis_tpu.scoring.saliency import get_saliency_fn as jget
    from elvis_tpu_torch.scoring import saliency as tsal

    frames = _clip(4, 64, 96, seed=2)
    got = tsal.get_saliency_fn("neural")(torch.from_numpy(frames))
    want = np.asarray(jget("neural")(jnp.asarray(frames)))
    assert got.dtype == torch.float32 and np.abs(got.numpy() - want).max() <= BF16_MAX_ABS
    fn = tsal._neural_saliency_fn(torch.device("cpu"))
    assert fn is tsal._neural_saliency_fn(torch.device("cpu"))  # loaded once
    assert fn.net.dtype == torch.bfloat16


def test_neural_falls_back_to_motion_contrast_without_weights(monkeypatch):
    from elvis_tpu_torch.models import io
    from elvis_tpu_torch.scoring import saliency as tsal

    monkeypatch.setattr(io, "weights_path", lambda name: None)
    tsal._neural_saliency_fn.cache_clear()
    try:
        frames = torch.from_numpy(_clip(3, 32, 48))
        assert tsal._neural_saliency_fn(frames.device) is tsal.motion_contrast_saliency
        torch.testing.assert_close(tsal.get_saliency_fn("neural")(frames),
                                   tsal.motion_contrast_saliency(frames), rtol=0, atol=0)
    finally:
        tsal._neural_saliency_fn.cache_clear()


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunked_scoring_is_exact_at_chunk_edges(chunk):
    """The net differences each frame against its predecessor: the scoring
    chunker's one-frame halo gives every chunk's first frame its true
    predecessor, so chunked features equal the unchunked ones."""
    from elvis_tpu_torch.pipeline.run import _scoring_features_chunked
    from elvis_tpu_torch.scoring import get_saliency_fn

    frames = torch.from_numpy(_clip(7, 64, 96, seed=3))
    sal = get_saliency_fn("neural")
    whole = _scoring_features_chunked(frames, 8, sal, 7)
    parts = _scoring_features_chunked(frames, 8, sal, chunk)
    for a, b in zip(parts, whole):
        assert torch.equal(a, b)
    # without the halo, a chunk's first frame sees no motion and differs
    cut = sal(frames[chunk:].float())[0]
    assert not torch.equal(cut, sal(frames.float())[chunk])
