"""The yardstick's counts against hand counts."""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import counts  # noqa: E402


def test_one_base3d_layer():
    # C32 -> F32 at B=8, D=64, 64x192: 2 x (8 * 64 * 64 * 192) outputs
    # x 32 features x 27 taps x 32 channels
    fb, ff, bb, bf = counts.convcomb_call(512, 32, 64 * 192, 32)
    assert ff == 2 * 512 * 12288 * 32 * 27 * 32 == 347_892_350_976
    assert bf == 2 * ff
    # bf16 x and y (402,653,184 bytes each), the tap-stacked weight
    # (96 x 32 x 9 x 2), a and b (2 x 32 x 4), the statistics (32 x 2 x 4)
    assert fb == 402_653_184 * 2 + 55_296 + 256 + 256


def test_one_encoder_conv():
    # stage 1's 64 -> 64 3x3 conv on B*T = 16 images at 64x192
    fb, ff, bb, bf = counts.convbn2d_call(16, 64, 64, 192, 64)
    assert ff == 2 * 16 * 12288 * 64 * 9 * 64 == 14_495_514_624
    assert fb == 2 * 16 * 64 * 12288 * 2 + 2 * 64 * 64 * 9 + 512 + 512
    assert counts.least_seconds(fb, ff) == max(fb / 3.35e12, ff / 989e12)


def test_step_count_is_the_sum_of_its_convs():
    with open(os.path.join(BENCH, "configs", "kitti-exp7.json")) as f:
        cfg = json.load(f)["config"]
    total = counts.step_flops(cfg, 8)
    b3d = (counts.conv2d_flops(512, 64, 192, 4, 32, 27)
           + 6 * 347_892_350_976 + counts.conv2d_flops(512, 64, 192, 32, 1,
                                                       27))
    # Base3D is the largest part; forward, dx and dW, both sides
    assert 2 * 3 * b3d < total < 2 * 3 * b3d * 3
    lc = dict(cfg, var=dict(cfg["var"], nmode="exp7_lc"))
    assert counts.step_flops(lc, 8) - total == 2 * 3 * counts.conv2d_flops(
        512, 64, 192, 1, 32, 27)


def test_one_correlation_call_at_pwclites_finest_level():
    # B=8, C=32, 96x208, md 4: x1 and x2 (8 * 32 * 96 * 208 f32 each) read,
    # the 81-channel output written
    fb, ff, bb, bf = counts.correlation_call(8, 32, 96, 208, 4)
    x, y = 4 * 8 * 32 * 96 * 208, 4 * 8 * 81 * 96 * 208
    assert (fb, bb) == (2 * x + y, 4 * x + y)
    assert ff == 2 * 8 * 81 * 32 * 96 * 208 and bf == 2 * ff
    # bound by bytes: 0.0277 ms forward, 0.0399 backward
    least = counts.least_seconds(fb, ff, counts.F32_FLOPS)
    assert least == fb / counts.HBM_BPS
    assert round(least * 1e3, 4) == 0.0277
    assert round(counts.least_seconds(bb, bf, counts.F32_FLOPS) * 1e3,
                 4) == 0.0399


def test_flow_step_count_is_the_sum_of_its_parts():
    m = {"search_range": 4, "output_level": 4}
    total = counts.flow_step_flops(m, 8, 384, 832)
    levels = counts._pwc_levels(384, 832)
    assert levels[0] == (192, 416, 16) and levels[-1] == (6, 13, 192)
    # the finest compared level (96x208, C=32): the estimator's first conv
    # and the correlation, forward, in each of the four passes
    est0 = counts.conv2d_flops(8, 96, 208, 81 + 32 + 2, 128)
    corr = 2.0 * 8 * 81 * 32 * 96 * 208
    assert 4 * (est0 + corr) < total
    # every term is linear in the batch
    one = counts.flow_step_flops(m, 1, 384, 832)
    assert abs(total - 8 * one) < 1e-6 * total
    assert round(total / 1e12, 2) == 5.42
