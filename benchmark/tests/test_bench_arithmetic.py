"""The yardstick's arithmetic against hand counts: work, rooflines, the
trace's intervals and percentiles."""

import math

import pytest

from benchmark.harness import peaks, stats, work
from benchmark.harness.trace import Trace, WINDOW_MARK, gaps, union


def test_dense_and_block_by_hand():
    assert work.dense(10, 3, 4) == 240
    # L 2, D 4: qkv 2*2*4*12, scores + attend 4*4*4, proj 2*2*4*4, MLP 2*2*4*16*2
    assert work.block(2, 4) == 192 + 64 + 64 + 512
    assert work.pos_embed(1, 4) == 2 * (3 * 128 + 128 * 4)


def test_attention_counts_by_hand():
    # forward: qkv 6 L D^2, scores and attend 2 L^2 D each, projection 2 L D^2
    assert work.attention_sublayer(64, 384, False) == 8 * 64 * 384 ** 2 + 4 * 64 ** 2 * 384
    # backward: dWproj, dO 2 L D^2 each; dP, dV, dQ, dK 2 L^2 D each; dWqkv, dx 6 L D^2 each;
    # nothing the kernel computes again (chip_smoke.py's 22 L D^2 + 12 L^2 D counts that)
    l, d = 64, 384
    by_hand = 2 * (2 * l * d * d) + 4 * (2 * l * l * d) + 2 * (6 * l * d * d)
    assert work.attention_sublayer(l, d, True) == by_hand == 16 * l * d ** 2 + 8 * l ** 2 * d
    # B 256: 20.9 GFLOP forward (PERF.md's table), 41.9 backward
    assert round(256 * work.attention_sublayer(64, 384, False) / 1e9, 1) == 20.9
    assert round(256 * work.attention_sublayer(64, 384, True) / 1e9, 1) == 41.9
    x = 256 * 64 * 384 * 4
    w = (4 * 384 * 384 + 384) * 4
    assert work.attention_bytes(256, 64, 384, False) == 2 * x + w
    assert work.attention_bytes(256, 64, 384, True) == 3 * x + 2 * w


def test_patch_embed_count_matches_chip_smoke():
    b, g, s, c = 256, 64, 32, 384
    flops = b * g * (s * 2.0 * (3 * 128 + 128 * 256 + 256 * 512 + 512 * c) + 2.0 * 256 * 512)
    assert work.patch_embed(b * g, s, c) == flops
    assert round(flops / 1e12, 3) == 0.383


def test_roofline_and_peak_shares():
    # 495 GFLOP in 10 ms is 10% of the TF32 peak; bytes bound when they take longer
    assert peaks.share_of_peak(495e9, 0.01) == pytest.approx(10.0)
    assert peaks.least_seconds(1e9, 3.35e9) == pytest.approx(1e-3)
    assert peaks.least_seconds(4.95e12, 1.0) == pytest.approx(0.01)


def test_intervals():
    assert union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reads_its_own_window():
    events = [_event(WINDOW_MARK, "user_annotation", 100.0, 100.0),
              _event("k1", "kernel", 90.0, 30.0),          # 20 us inside
              _event("attn_fwd_kernel<float>", "kernel", 130.0, 20.0),
              _event("attn_fwd_kernel<float>", "kernel", 140.0, 20.0),  # overlaps the one before
              _event("Memcpy HtoD", "gpu_memcpy", 190.0, 50.0),  # 10 us inside
              _event("aten::mm", "cpu_op", 150.0, 40.0)]
    t = Trace(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(60e-6)
    assert t.kernel_seconds(["attn_fwd_kernel"]) == (pytest.approx(30e-6), 2)
    idle = dict(t.idle_gaps())
    assert sum(idle.values()) == pytest.approx(40e-6)
    assert idle["aten::mm"] == pytest.approx(30e-6)  # the gap 160 - 190 us


def test_percentile():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([1, 2, 3, 4], 95) == pytest.approx(3.85)
    assert stats.percentile([1, 2, math.inf], 95) == math.inf


def test_mask_judging_takes_only_ties():
    import torch

    from benchmark.reference.plain import geometric_mask, judge_masks

    # 8 groups, 4 masked, 2 of them by predicted loss: groups 6 and 7 (the largest);
    # group 5 lies 1e-7 below group 6, group 4 far below
    lp = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.5, 0.8 - 1e-7, 0.8, 0.9]])
    noise = torch.tensor([[0.9, 0.1, 0.2, 0.3, 0.4, 0.05, 0.06, 0.07]])
    ours = geometric_mask(lp, 4, 0.5, noise)
    swapped = lp.clone()
    swapped[0, [5, 6]] = swapped[0, [6, 5]]
    tied = geometric_mask(swapped, 4, 0.5, noise)
    assert not torch.equal(ours, tied)
    mask, taken = judge_masks(lp, 4, 0.5, noise, tied, tie=5e-7)
    assert taken == 1 and torch.equal(mask, tied)
    far = lp.clone()
    far[0, [4, 6]] = far[0, [6, 4]]
    wrong = geometric_mask(far, 4, 0.5, noise)
    mask, taken = judge_masks(lp, 4, 0.5, noise, wrong, tie=5e-7)
    assert taken == 0 and torch.equal(mask, ours)
