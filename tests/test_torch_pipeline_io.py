"""Port parity: clip I/O, the stdlib PNG reader/writer, Y4M and the stage
cache (``elvis_tpu_torch.pipeline.io``, ``codec.y4m``, ``pipeline.cache``)
against ``elvis_tpu``.

Tolerances: synthetic clips, npz/npy/png sources, masks and digests are
EXACT. A resize (float32 matrix products whose sums run in another order)
and the I420 -> RGB of a Y4M or NVC source may move a pixel by 1 LSB at a
.5 tie. The PNG codec is exact both ways against PIL, for every filter.
"""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from elvis_tpu.codec import y4m as jy4m
from elvis_tpu.pipeline import cache as jcache
from elvis_tpu.pipeline import io as jio
from elvis_tpu_torch.codec import y4m as ty4m
from elvis_tpu_torch.pipeline import cache as tcache
from elvis_tpu_torch.pipeline import io as tio


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _max_lsb(a, b):
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


@pytest.mark.parametrize("kind,frames,h,w,seed", [("moving", 5, 48, 64, 0),
                                                  ("static", 3, 36, 50, 7),
                                                  ("object", 4, 64, 96, 3)])
def test_synthetic_clip_bytes_equal(kind, frames, h, w, seed):
    t = tio.synthetic_clip(kind, frames=frames, height=h, width=w, seed=seed)
    j = jio.synthetic_clip(kind, frames=frames, height=h, width=w, seed=seed)
    assert t.dtype == np.uint8 and t.tobytes() == j.tobytes()


@pytest.mark.parametrize("source,w,h,mf,tol", [
    ("synthetic://moving?frames=4&fps=24", 64, 48, None, 0),
    ("synthetic://moving?frames=5&height=48&width=80&seed=2", 64, 40, 3, 1),  # area shrink
    ("synthetic://object?frames=2&height=24&width=32", 48, 40, None, 1),  # lanczos grow
])
def test_load_clip_synthetic(source, w, h, mf, tol):
    tf, tfps = tio.load_clip(source, w, h, mf, device="cpu")
    jf, jfps = jio.load_clip(source, w, h, mf)
    assert tfps == jfps and tf.shape == jf.shape and tf.dtype == np.uint8
    assert _max_lsb(tf, jf) <= tol


def test_load_clip_npz_npy_png_dir(tmp_path, tiny_video):
    np.savez(tmp_path / "c.npz", frames=tiny_video, framerate=25.0)
    np.save(tmp_path / "c.npy", tiny_video)
    jio.save_frames_png(tiny_video, str(tmp_path / "pngs"))  # PIL writes them
    for src in ("c.npz", "c.npy", "pngs"):
        tf, tfps = tio.load_clip(str(tmp_path / src), device="cpu")
        jf, jfps = jio.load_clip(str(tmp_path / src))
        assert tfps == jfps and np.array_equal(tf, jf), src
    assert tio.load_clip(str(tmp_path / "c.npz"), max_frames=2, device="cpu")[0].shape[0] == 2


def test_y4m_write_read_against_jax(tmp_path, tiny_video):
    ty4m.write_y4m(tiny_video, str(tmp_path / "t.y4m"), 24.0)
    jy4m.write_y4m(tiny_video, str(tmp_path / "j.y4m"), 24.0)
    tb, jb = (tmp_path / "t.y4m").read_bytes(), (tmp_path / "j.y4m").read_bytes()
    assert len(tb) == len(jb) and tb[:40] == jb[:40]
    assert _max_lsb(np.frombuffer(tb, np.uint8), np.frombuffer(jb, np.uint8)) <= 1
    tf, tfps = tio.load_clip(str(tmp_path / "j.y4m"), device="cpu")
    jf, jfps = jio.load_clip(str(tmp_path / "j.y4m"))
    assert tfps == jfps == 24.0 and tf.shape == tiny_video.shape and _max_lsb(tf, jf) <= 1


def test_load_clip_nvc(tmp_path, tiny_video):
    from elvis_tpu.codec.nvc.codec import encode as jencode

    (tmp_path / "c.nvc").write_bytes(jencode(tiny_video, qp=24, framerate=30.0))
    tf, tfps = tio.load_clip(str(tmp_path / "c.nvc"), device="cpu")
    jf, jfps = jio.load_clip(str(tmp_path / "c.nvc"))
    assert tfps == jfps and tf.shape == jf.shape and _max_lsb(tf, jf) <= 1


def test_loaders_refuse_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_clip("synthetic://moving?frames=2", 64, 48)  # the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_masks(str(tmp_path), 8, 8, 2)


def test_mp4_is_not_ported_yet(monkeypatch, tmp_path):
    """An mp4 source reads through ffmpeg now; with no ffmpeg (and no
    codec shim) it raises JAX's FileNotFoundError."""
    monkeypatch.delenv("ELVIS_TPU_FAKE_CODECS", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no ffmpeg in this environment"):
        tio.load_clip("clip.mp4", 64, 48, device="cpu")


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG whose row y uses filter ``filters[y % len(filters)]``
    (None, Sub, Up, Average, Paeth as the PNG spec defines them)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        x = rows[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - cc
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
        out += bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prev = x

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_all_five_filters_against_pil(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 11, channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, [0, 1, 2, 3, 4]))
    pil = np.asarray(Image.open(path))
    pil = pil[..., None] if pil.ndim == 2 else pil
    assert np.array_equal(pil, img)  # the file is what the spec says
    assert np.array_equal(tio.read_png(str(path)), img)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_roundtrip_against_pil_both_ways(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    c = len(mode)
    # smooth content, so PIL's encoder picks filters other than None
    yy, xx = np.mgrid[0:40, 0:56]
    img = ((yy * 3 + xx * 2)[..., None] + rng.integers(0, 4, (40, 56, c))).astype(np.uint8)
    arr = img[..., 0] if c == 1 else img
    Image.fromarray(arr, mode).save(tmp_path / "pil.png")
    assert np.array_equal(tio.read_png(str(tmp_path / "pil.png")), img)
    tio.write_png(str(tmp_path / "ours.png"), arr)
    back = np.asarray(Image.open(tmp_path / "ours.png"))
    assert Image.open(tmp_path / "ours.png").mode == mode and np.array_equal(back, arr)


def test_palette_masks_read_as_pil_converts_them(tmp_path):
    """DAVIS annotations are 8-bit palette PNGs: read as RGB, and as masks
    through PIL's grey conversion, as the JAX package reads them."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 3, (24, 40)).astype(np.uint8)
    img = Image.fromarray(idx, "P")
    img.putpalette([0, 0, 0, 128, 0, 0, 255, 255, 255] + [0] * 759)
    (tmp_path / "m").mkdir()
    img.save(tmp_path / "m" / "00000.png")
    rgb = np.asarray(Image.open(tmp_path / "m" / "00000.png").convert("RGB"))
    assert np.array_equal(tio.read_png(str(tmp_path / "m" / "00000.png")), rgb)
    assert np.array_equal(tio.load_masks(str(tmp_path / "m"), 40, 24, 2, device="cpu"),
                          jio.load_masks(str(tmp_path / "m"), 40, 24, 2))


def test_save_load_frames_png_equal_jax(tmp_path, tiny_video):
    tio.save_frames_png(torch.from_numpy(tiny_video), str(tmp_path / "t"))
    assert sorted(p.name for p in (tmp_path / "t").iterdir())[0] == "00001.png"
    assert np.array_equal(jio.load_frames_png(str(tmp_path / "t")), tiny_video)
    assert np.array_equal(tio.load_frames_png(str(tmp_path / "t")), tiny_video)


def test_load_masks_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    d = tmp_path / "masks"
    d.mkdir()
    for i in range(3):  # grey masks at another size, and one RGB mask
        m = (rng.random((20, 30)) > 0.5).astype(np.uint8) * 255
        img = Image.fromarray(m) if i < 2 else Image.fromarray(
            np.stack([m, rng.integers(0, 256, m.shape).astype(np.uint8), m], -1))
        img.save(d / f"{i:05d}.png")
    t = tio.load_masks(str(d), 64, 40, 5, device="cpu")  # frames 3, 4 carry the last mask
    j = jio.load_masks(str(d), 64, 40, 5)
    assert t.dtype == bool and t.shape == (5, 40, 64) and np.array_equal(t, j)
    assert np.array_equal(tio.load_masks(str(tmp_path / "none"), 8, 8, 2, device="cpu"),
                          jio.load_masks(str(tmp_path / "none"), 8, 8, 2))


@pytest.mark.parametrize("obj", [
    ["v2", {"width": 64, "inpaint_backends": ["diffusion"], "x": None}],
    [np.arange(12, dtype=np.int16).reshape(3, 4), b"\x00\x01", 1.5, "s", (2, [3.0])],
    {"b": np.zeros((2, 2), bool), "a": [np.float32(0.25), {"k": 7}]},
])
def test_digest_equal_jax(obj):
    assert tcache._digest(obj) == jcache._digest(obj)


def test_digest_of_a_tensor_and_of_the_config():
    """A tensor digests as its host copy; the default config dicts (the
    branch key's first part) digest alike."""
    from elvis_tpu.pipeline.config import ElvisConfig as JConfig
    from elvis_tpu_torch.pipeline.config import ElvisConfig as TConfig

    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    assert tcache._digest([torch.from_numpy(a)]) == jcache._digest([a])
    assert tcache._digest([TConfig().to_dict(), a]) == jcache._digest([JConfig().to_dict(), a])


def test_stage_cache_roundtrip_to_the_device(tmp_path):
    cache = tcache.StageCache(str(tmp_path / "sc"))
    calls = []

    def fn():
        calls.append(1)
        return {"stream": b"abc", "frames": torch.arange(6, dtype=torch.uint8).reshape(2, 3),
                "mask": np.ones((2,), bool)}

    first = cache.get_or_run("enc", ["k", 1], fn, device="cpu")
    again = cache.get_or_run("enc", ["k", 1], fn, device="cpu")
    other = cache.get_or_run("enc", ["k", 2], fn)
    assert calls == [1, 1] and cache.hits == ["enc"] and cache.misses == ["enc", "enc"]
    for r in (first, again):
        assert r["stream"] == b"abc" and isinstance(r["frames"], torch.Tensor)
        assert torch.equal(r["frames"], torch.arange(6, dtype=torch.uint8).reshape(2, 3))
        assert r["mask"].dtype == torch.bool
    assert isinstance(other["mask"], np.ndarray)  # no device: as fn returned it
    # the file name is the JAX package's for the same key
    assert (tmp_path / "sc" / f"enc_{jcache._digest(['enc', ['k', 1]])}.npz").exists()
    off = tcache.StageCache(str(tmp_path / "off"), enabled=False)
    assert off.get_or_run("enc", [], fn, device="cpu")["stream"] == b"abc" and not off.hits
