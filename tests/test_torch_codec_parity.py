"""Port parity: the NVC codec as a whole (elvis_tpu_torch.codec.nvc against
elvis_tpu.codec.nvc, on the CPU, tiny clips).

The port's encoder is not promised bit-exact to the JAX encoder: Qstep
differs by an ulp at 7 QPs and sums run in another order, so a rounding tie,
a cost comparison or an argmin tie may fall the other way, and a flipped
block gives another valid stream. The bars are therefore:

* decoders: each package decodes the other's streams to frames that differ
  by at most 1 LSB on at most 0.1% of the pixels, in every flag case;
* encoders at fixed QP: the same header and section layout, at least 99% of
  the blocks with equal (mode, vector, levels) in the default case, 97% in
  the other flag cases and 80% under the hierarchical search (on the fast pan
  the blocks of the last column, whose motion leaves the frame, have
  candidates whose SADs tie to the last bit; the tie falls by the order of
  summation, and a flipped vector changes the reference of every later
  frame); the shares are printed; stream length within 1%,
  PSNR of the decoded clip against the source within 0.02 dB; byte-identical
  streams are asserted where they come out so;
* the port's chunked stream equals its single-loop stream byte for byte;
* rate targeting: the chosen QP within 1 of JAX's, the size within 15% of
  the target where JAX's is.
"""

import numpy as np
import pytest
import torch

from elvis_tpu.codec.nvc import codec as jc
from elvis_tpu_torch.codec.nvc import codec as tc

QP = 26


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clip(n=6, h=48, w=64, seed=0, speed=3):
    """Moving gradients plus noise: structure for the motion search, noise
    for the quantizer."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        base = (128 + 60 * np.sin(2 * np.pi * (xx + speed * t) / 32)
                + 40 * np.cos(2 * np.pi * (yy + t) / 24))
        img = np.stack([base, np.roll(base, 3, axis=1), np.roll(base, -2, axis=0)], axis=-1)
        frames.append(np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))
    return np.stack(frames)


def _roi(n=6, by=6, bx=8):
    return np.random.default_rng(1).integers(-10, 11, (n, by, bx)).astype(np.int8)


CASES = {  # name -> (clip arguments, encode arguments)
    "default_gop3": ({}, dict(gop=3)),
    "no_deblock": ({}, dict(deblock=False)),
    "no_intra_pred": ({}, dict(intra_pred=False)),
    "multi_ref": ({}, dict(multi_ref=True)),
    "b_frames": ({}, dict(b_frames=True, gop=4)),
    "hierarchical_r12": (dict(speed=10), dict(me_radius=12)),
    "roi": ({}, dict(roi_delta_qp=_roi(), gop=3)),
    "chunked": ({}, dict(chunk_frames=2, gop=3)),
    "odd_size_40x56": (dict(h=40, w=56), dict(gop=4)),
}


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def coded():
    """Per case, made once: the clip, both encoders' streams, and each
    stream decoded by both decoders."""
    cache = {}

    def get(name):
        if name not in cache:
            clip_kw, enc_kw = CASES[name]
            frames = _clip(**clip_kw)
            sj = jc.encode(frames, qp=QP, **enc_kw)
            st = tc.encode(frames, qp=QP, device="cpu", **enc_kw)
            dec = {}
            for who, s in (("jax", sj), ("torch", st)):
                dj, fj = jc.decode(s)
                dt, ft = tc.decode(s, device="cpu")
                assert fj == ft == 30.0 and dt.dtype == torch.uint8
                dec[who] = (np.asarray(dj), dt.numpy())
            cache[name] = (frames, sj, st, dec)
        return cache[name]

    return get


@pytest.mark.parametrize("stream_of", ["jax", "torch"])
@pytest.mark.parametrize("name", list(CASES))
def test_decoders_agree_on_either_stream(coded, name, stream_of):
    frames, _, _, dec = coded(name)
    by_jax, by_port = dec[stream_of]
    assert by_port.shape == by_jax.shape == frames.shape
    diff = np.abs(by_port.astype(int) - by_jax.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert _psnr(frames, by_port) > 30.0


def _block_share(sa, sb):
    """Share of blocks, all planes, with equal (mode, vector, levels)."""
    _, _, pa = tc.read_stream(sa)
    _, _, pb = tc.read_stream(sb)
    same, total = 0, 0
    for (la, ma, va), (lb, mb, vb) in zip(pa, pb):
        n, by, bx = ma.shape
        eq = ((ma == mb) & (la == lb).all(axis=-1)
              & (va.reshape(n, by, bx, -1) == vb.reshape(n, by, bx, -1)).all(axis=-1))
        same, total = same + int(eq.sum()), total + eq.size
    return same / total


@pytest.mark.parametrize("name", list(CASES))
def test_encoders_agree_at_fixed_qp(coded, name):
    frames, sj, st, dec = coded(name)
    assert tc._read_header(st) == tc._read_header(sj)
    assert tc.section_backends(st) == tc.section_backends(sj)
    share = _block_share(sj, st)
    p_j, p_t = _psnr(frames, dec["jax"][0]), _psnr(frames, dec["torch"][1])
    print(f"{name}: {share:.2%} of blocks equal; {len(sj)} and {len(st)} bytes; PSNR "
          f"{p_j:.4f} and {p_t:.4f} dB; identical: {sj == st}")
    assert share >= {"default_gop3": 0.99, "hierarchical_r12": 0.80}.get(name, 0.97), share
    assert abs(len(st) - len(sj)) <= 0.01 * len(sj)
    assert abs(p_t - p_j) <= 0.02
    if share == 1.0:
        assert st == sj


def test_modes_and_gop_structure(coded):
    _, sj, st, _ = coded("default_gop3")
    modes = tc.luma_modes(st)
    for t in range(6):
        intra_frame = not ((modes[t] == 1) | (modes[t] == 2)).any()
        assert intra_frame == (t % 3 == 0)
    _, _, st_b, _ = coded("b_frames")
    assert tc._read_header(st_b)[8] == 3  # 1 + b_qp_offset
    _, _, st_m, _ = coded("multi_ref")
    assert (tc.luma_modes(st_m) == 2).any()  # the two-back reference was chosen somewhere
    _, _, st_h, _ = coded("hierarchical_r12")
    _, _, planes = tc.read_stream(st_h)
    assert np.abs(planes[0][2].astype(int)).max() > 16  # vectors beyond the dense search


@pytest.mark.parametrize("flags", [dict(gop=3), dict(gop=0, multi_ref=True),
                                   dict(gop=4, deblock=False, intra_pred=False)])
def test_chunked_equals_single_loop_byte_for_byte(flags):
    frames = _clip(n=7)
    single = tc.encode(frames, qp=QP, device="cpu", chunk_frames=16, **flags)
    for chunk in (2, 3):
        assert tc.encode(frames, qp=QP, device="cpu", chunk_frames=chunk, **flags) == single
    assert tc.encode(torch.from_numpy(frames), qp=QP, chunk_frames=2, **flags) == single


def test_chunked_decode_equals_single_loop(monkeypatch):
    frames = _clip(n=7)
    stream = tc.encode(frames, qp=QP, device="cpu", gop=3, multi_ref=True)
    whole, _ = tc.decode(stream, device="cpu")
    monkeypatch.setattr(tc, "_CHUNK_PIXEL_BUDGET", 3 * 48 * 64)
    parts, _ = tc.decode(stream, device="cpu")
    assert torch.equal(parts, whole)


def test_b_frames_in_batches_equal_one_batch(monkeypatch):
    """B frames go through the encoder and the decoder in batches cut by a
    pixel budget; one frame a batch gives what one batch of all gives."""
    from elvis_tpu_torch.codec.nvc import transform as tt

    frames = _clip(n=7)
    whole = tc.encode(frames, qp=QP, device="cpu", b_frames=True, gop=4)
    frames_whole, _ = tc.decode(whole, device="cpu")
    assert len(tt._b_batches(3, 48, 64)) == 1
    monkeypatch.setattr(tt, "_B_BATCH_PIXELS", 48 * 64)
    assert tt._b_batches(3, 48, 64) == [(0, 1), (1, 2), (2, 3)]
    assert tc.encode(frames, qp=QP, device="cpu", b_frames=True, gop=4) == whole
    assert torch.equal(tc.decode(whole, device="cpu")[0], frames_whole)


def test_encode_is_deterministic_and_takes_tensors():
    frames = _clip()
    a = tc.encode(frames, qp=QP, device="cpu")
    assert tc.encode(torch.from_numpy(frames), qp=QP) == a  # a tensor encodes where it lies
    assert tc.encode(torch.from_numpy(frames), qp=QP, device="cpu") == a


def test_encoder_and_decoder_reconstructions_are_the_same_bits():
    """The encoder's own reconstruction is what the decoder rebuilds."""
    from elvis_tpu_torch.codec.nvc import transform as tt

    plane = torch.from_numpy(_clip()[..., 1].astype(np.float32))
    qp_map = torch.full((6, 6, 8), QP)
    for kw in (dict(gop=3, deblock=True), dict(multi_ref=True, deblock=True),
               dict(intra_pred=False)):
        lv, md, mv, rec = tt.encode_plane(plane, qp_map, **kw)
        out = tt.decode_plane(lv, md, mv, qp_map, 48, 64, multi_ref=kw.get("multi_ref", False),
                              deblock=kw.get("deblock", False))
        assert torch.equal(out, rec)
    lv, md, mv, rec = tt.encode_plane_b(plane, qp_map, gop=4, deblock=True)
    assert torch.equal(tt.decode_plane_b(lv, md, mv, qp_map, 48, 64, deblock=True), rec)


def test_rate_targeting_two_pass_matches():
    frames = _clip()
    jcodec, tcodec = jc.NvcCodec(), tc.NvcCodec("cpu")
    for target in (60_000.0, 200_000.0):
        sj = jcodec.encode(frames, target_bitrate=target, gop=3)
        st = tcodec.encode(frames, target_bitrate=target, gop=3)
        qj, qt = jcodec.probe(sj).base_qp, tcodec.probe(st).base_qp
        print(f"target {target:.0f}: QP {qj} and {qt}, {len(sj)} and {len(st)} bytes")
        assert abs(qt - qj) <= 1
        bits = target * len(frames) / 30.0
        if abs(len(sj) * 8 - bits) <= 0.15 * bits:
            assert abs(len(st) * 8 - bits) <= 0.15 * bits
    with pytest.raises(ValueError, match="exactly one"):
        tcodec.encode(frames)
    with pytest.raises(ValueError, match="exactly one"):
        tcodec.encode(frames, qp=30, target_bitrate=1e5)


def test_rate_targeting_prefix_route_matches(monkeypatch):
    """Long clips fit the rate model on prefixes and pay one full encode."""
    frames = _clip(n=12, h=32, w=48)
    monkeypatch.setattr(jc, "_PREFIX_PROBE_MIN_FRAMES", 12)
    monkeypatch.setattr(tc, "_PREFIX_PROBE_MIN_FRAMES", 12)
    calls = []
    plain = tc.encode
    monkeypatch.setattr(tc, "encode", lambda f, **kw: calls.append(f.shape[0]) or plain(f, **kw))
    target = 150_000.0
    sj = jc.NvcCodec().encode(frames, target_bitrate=target, gop=4)
    st = tc.NvcCodec("cpu").encode(frames, target_bitrate=target, gop=4)
    qj, qt = jc.NvcCodec().probe(sj).base_qp, tc.NvcCodec("cpu").probe(st).base_qp
    print(f"prefix route: QP {qj} and {qt}, {len(sj)} and {len(st)} bytes, encodes of {calls}")
    assert abs(qt - qj) <= 1
    assert calls.count(12) == 1 and len(calls) >= 3  # prefixes, then one full encode
    assert abs(len(st) - len(sj)) <= 0.15 * len(sj)


def test_argument_checks():
    frames = _clip(n=2)
    with pytest.raises(ValueError, match="b_qp_offset"):
        tc.encode(frames, b_frames=True, b_qp_offset=255, device="cpu")
    from elvis_tpu_torch.codec.nvc import transform as tt
    with pytest.raises(ValueError, match="me_radius"):
        tt.encode_plane(torch.zeros(1, 16, 16), torch.full((1, 2, 2), 30), me_radius=57)


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = _clip(n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.encode(frames, qp=30)  # a numpy array goes to the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.decode(tc.encode(frames, qp=30, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.NvcCodec()
