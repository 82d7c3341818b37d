"""The general generator: the same seed makes the same inputs, another seed
other inputs of the same sizes."""

import json

import torch

from port_bench.harness import content, spec

SEEDS = (2**31 + 5, 2**31 + 6)


def _mix(name):
    return spec.traffic(name)


def _segments(seed, mix="segments_1080p_source", n=3, h=48, w=64):
    params = _mix(mix)["content"]
    return content.make_segments(params, 2, n, h, w, content.generator(seed, "cpu"), "cpu")


def test_same_seed_same_segments():
    a, b = _segments(SEEDS[0]), _segments(SEEDS[0])
    assert a.dtype == torch.uint8 and a.shape == (2, 3, 48, 64, 3)
    assert torch.equal(a, b)


def test_other_seed_other_segments_and_distinct_pool():
    a, b = _segments(SEEDS[0]), _segments(SEEDS[1])
    assert a.shape == b.shape
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    # colour content, not grey
    assert (a[..., 0].int() - a[..., 1].int()).abs().float().mean() > 5


def test_a_fixed_scene_seed_gives_every_seed_the_same_scenes_in_another_order():
    """Where a mix names ``scene_seed``, the run's seed draws only the noise
    and the pool's order: without noise the pools of two seeds hold the same
    segments; with it they differ."""
    params = dict(_mix("segments_1080p_source")["content"], scene_seed=7, noise_sigma=0.0)

    def pool(seed, p=params):
        return content.make_segments(p, 3, 2, 40, 56, content.generator(seed, "cpu"), "cpu")

    def as_set(x):
        return sorted(x[i].flatten().tolist() for i in range(x.shape[0]))

    orders = set()
    for seed in range(2**31 + 1, 2**31 + 7):
        a = pool(seed)
        assert as_set(a) == as_set(pool(SEEDS[0]))
        orders.add(tuple(int(a[i, 0, 0, 0, 0]) for i in range(3)))
    assert len(orders) > 1
    noisy = dict(params, noise_sigma=2.0)
    assert not torch.equal(pool(SEEDS[0], noisy), pool(SEEDS[1], noisy))
    lv = dict(_mix("segments_1080p_client")["levels"], scene_seed=7)
    a, b = (content.make_levels(lv, 3, 2, 9, 16, content.generator(s, "cpu"), "cpu")
            for s in SEEDS)
    assert as_set(a) == as_set(b)


def test_levels_hold_every_segment_max_level():
    params = _mix("segments_1080p_restore")["levels"]
    for seed in SEEDS:
        lv = content.make_levels(params, 3, 4, 9, 16, content.generator(seed, "cpu"), "cpu")
        assert lv.shape == (3, 4, 9, 16) and lv.dtype == torch.int32
        assert lv.min() >= 0
        assert all(int(lv[s].max()) == params["max_level"] for s in range(3))
    a = content.make_levels(params, 1, 4, 9, 16, content.generator(SEEDS[0], "cpu"), "cpu")
    b = content.make_levels(params, 1, 4, 9, 16, content.generator(SEEDS[0], "cpu"), "cpu")
    assert torch.equal(a, b)


def test_degrade_averages_each_block_by_its_level():
    frames = _segments(SEEDS[0], n=2, h=16, w=16)[0]
    levels = torch.tensor([[[0, 3], [1, 2]]] * 2, dtype=torch.int32)
    out = content.degrade(frames, levels, 8)
    assert torch.equal(out[:, :8, :8], frames[:, :8, :8])  # level 0 untouched
    block = frames[:, :8, 8:].float().mean(dim=(1, 2))       # level 3: one value per block
    assert torch.equal(out[:, :8, 8:], torch.round(block)[:, None, None].expand(2, 8, 8, 3)
                       .to(torch.uint8))
    assert len(torch.unique(out[0, 8:, :8, 0])) <= 16        # level 1: 2x2 cells


def test_every_mix_names_a_path_and_parses():
    for w in spec.load_benchmark()["workloads"]:
        mix = spec.traffic(w["traffic"])
        assert (spec.ROOT / spec.BENCH_DIR / "paths" / f"{mix['path']}.py").is_file()
        json.dumps(mix)
