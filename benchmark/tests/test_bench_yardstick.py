# -*- coding: utf-8 -*-
"""The frozen counts against hand counts at the 45-min chunk
[270000, 120] (12 kHz mu-law int8)."""
import math

import pytest

from benchmark.harness import yardstick as y

T, W, RATE = 270000, 120, 12000


def test_filterbank_and_bands_at_12khz():
    f = W // 2 + 1  # 61 bins of 100 Hz
    mel = y.mel_filterbank(f, RATE)
    bands = y.band_selector(f, RATE, W)
    assert mel.shape == (f, 40) and bands.shape == (f, 6)
    # bins 1..39 (100-3900 Hz) fall in the six bands [80, 4000) Hz
    assert bands.sum() == 39 and (bands.sum(axis=1) <= 1).all()
    assert int((mel > 0).sum()) == 114


def test_frontend_work_at_the_chunk():
    ops, nbytes = y.frontend_work(T, W, RATE, W)
    per_window = 4 * 120 * 61 + 8 * 61 + 6 * 61 + 39 + 2 * 114 + 2 * 40 + 2 * 120 + 1
    assert ops == T * per_window == 8294940000
    assert nbytes == T * (120 + 47 * 4) == 83160000
    # operations bound it: 0.1238 ms at 67 TFLOP/s against 0.0248 ms of bytes
    assert y.frontend_bound_s(T, W, RATE, W) == pytest.approx(ops / 67e12)
    assert ops / 67e12 * 1e3 == pytest.approx(0.12380, abs=1e-5)


def test_scan_bytes_at_the_chunk():
    by_hand = (4 * 6 + 2 * 6) * 4 * T + 2 * 2 * 4 * (T + 60) + 3 * 2 * 2 * 4 * (T + 85) \
        + 2 * 2 * 4 * T
    assert y.scan_bytes(T) == by_hand == 60485040
    assert y.scan_bound_s(T) == pytest.approx(by_hand / 3.35e12)
    assert y.scan_ops(T) < y.scan_bytes(T) / 3.35e12 * 67e12


def test_net_and_search_flops():
    per_row = 2 * (43 * 96 + 7 * 96 * 96 * 5 + 96)
    assert y.net_flops(T) == (T + 320) * per_row
    assert y.net_flops(T) / 1e9 == pytest.approx(176.67, abs=0.01)
    n = 1 << 21
    fft = 2.5 * n * math.log2(n)
    assert y.search_flops(n, 1, 7) == pytest.approx(fft + 7 * (2 * fft + 6 * (n // 2 + 1) + 2 * n))
    assert y.search_flops(n, 10, 7) == pytest.approx(10 * y.search_flops(n, 1, 7))
