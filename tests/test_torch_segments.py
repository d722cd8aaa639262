# -*- coding: utf-8 -*-
"""The port's multi-segment source against the JAX package's: segment
placement, the cases of tests/test_multi_segment.py, and a WAV sync with
disjoint segments through both CLIs."""
import os

import numpy as np
import pytest
import torch

from ffsubsync_tpu.cli import make_parser
from ffsubsync_tpu.constants import FRAMERATE_RATIOS
from ffsubsync_tpu.media.segments import MultiSegmentVideoSpeechSource as JaxSource
from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.sync import run as jax_run
from ffsubsync_tpu_torch.media.segments import MultiSegmentVideoSpeechSource
from ffsubsync_tpu_torch.ops.align import align_candidates
from ffsubsync_tpu_torch.subs.raster import RasterSpec
from ffsubsync_tpu_torch.sync import run as torch_run

from tests.helpers import write_wav

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    # the reference's one-launch VAD program (Pallas in interpret mode),
    # which the port's _vad_program mirrors
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")


def _source(**kw):
    defaults = dict(
        vad="webrtc", sample_rate=100, frame_rate=48000, non_speech_label=0.0, device=CPU
    )
    defaults.update(kw)
    return MultiSegmentVideoSpeechSource(**defaults)


@pytest.mark.parametrize("skip_intro_outro", [False, True])
@pytest.mark.parametrize("segment_count", [1, 2, 3, 8, 13])
def test_segment_starts_match_reference(segment_count, skip_intro_outro):
    kw = dict(segment_count=segment_count, skip_intro_outro=skip_intro_outro)
    ours = _source(**kw)
    theirs = JaxSource(vad="webrtc", sample_rate=100, frame_rate=48000,
                       non_speech_label=0.0, **kw)
    for duration in (30.0, 60.0, 60.5, 100.0, 150.0, 151.0, 400.0, 1000.0, 3600.0, 5400.0):
        assert ours._segment_starts(duration) == theirs._segment_starts(duration), duration


def test_segment_starts_even_spacing():
    starts = _source(segment_count=4, segment_duration=60)._segment_starts(3600.0)
    assert len(starts) == 4
    assert starts[0] == 0
    assert starts[-1] == 3540
    gaps = np.diff(starts)
    assert np.allclose(gaps, gaps[0], atol=1)


def test_segment_starts_short_reference():
    assert _source(segment_count=8, segment_duration=60)._segment_starts(45.0) == [0]


def test_segment_starts_margins():
    starts = _source(segment_count=3, segment_duration=60, skip_intro_outro=True)._segment_starts(1000.0)
    assert starts[0] >= 30
    assert starts[-1] <= 1000 - 60 - 60


def test_subs_then_prefix_stripped():
    assert _source(vad="subs_then_webrtc").vad == "webrtc"


def test_sparse_assembly_and_partial_failures(monkeypatch):
    src = _source(segment_count=4, parallel_workers=2)
    monkeypatch.setattr(src, "_probe_total_duration", lambda fname: 400.0)

    def fake_extract(fname, start):
        if start > 250:
            raise RuntimeError("flaky segment")
        return start, np.ones(60 * 100)

    monkeypatch.setattr(src, "_extract_segment_speech", fake_extract)
    signal = src.fit("movie.mkv").transform()
    assert len(signal) == 400 * 100 + 2
    for s in src._segment_starts(400.0):
        assert signal[s * 100 + 10] == (1.0 if s <= 250 else 0.0)


def test_all_segments_failing_raises(monkeypatch):
    src = _source(segment_count=4)
    monkeypatch.setattr(src, "_probe_total_duration", lambda fname: 400.0)

    def fail(fname, start):
        raise RuntimeError("down")

    monkeypatch.setattr(src, "_extract_segment_speech", fail)
    with pytest.raises(ValueError, match="Unable to detect speech"):
        src.fit("movie.mkv")


def test_probe_failure_raises_actionable(monkeypatch):
    src = _source()

    def boom(fname):
        raise RuntimeError("no ffprobe")

    monkeypatch.setattr(src, "_probe_total_duration", boom)
    with pytest.raises(ValueError, match="multi-segment sync needs"):
        src.fit("movie.mkv")


def test_synthetic_recovery_from_sparse_segments():
    """A sparse sampled signal still recovers the true (scale, offset)
    through the port's candidate-ratio search on the device."""
    rng = np.random.RandomState(42)
    sample_rate = 100
    total = 1800.0
    true_ratio = FRAMERATE_RATIOS[1]
    true_offset = 12.34
    ref = (rng.rand(int(total * sample_rate)) > 0.8).astype(float)
    sub_len = int((total - true_offset) / true_ratio * sample_rate) + 10
    t_ref = np.round((np.arange(sub_len) / sample_rate * true_ratio + true_offset)
                     * sample_rate).astype(int)
    sub = np.where(t_ref < len(ref), ref[np.minimum(t_ref, len(ref) - 1)], 0.0)
    sparse = np.zeros_like(ref)
    for s in np.linspace(0, total - 60, 8).astype(int):
        sparse[s * sample_rate:(s + 60) * sample_rate] = ref[s * sample_rate:(s + 60) * sample_rate]
    ratios = [1.0] + FRAMERATE_RATIOS + [1.0 / r for r in FRAMERATE_RATIOS]
    starts_idx = np.nonzero(np.diff(np.concatenate([[0], sub])) > 0)[0]
    ends_idx = np.nonzero(np.diff(np.concatenate([sub, [0]])) < 0)[0] + 1
    candidates = []
    for ratio in ratios:
        n = int(sub_len * ratio) + 2
        candidates.append(RasterSpec(
            n_samples=n,
            starts=np.clip(np.round(starts_idx * ratio).astype(np.int32), 0, n),
            ends=np.clip(np.round(ends_idx * ratio).astype(np.int32), 0, n),
            weight=min(1.0 / ratio, 1.0),
            max_time=n / 100.0,
            sample_rate=sample_rate,
        ))
    results = align_candidates(sparse, candidates, max_offset_samples=6000, device=CPU)
    best = max(range(len(results)), key=lambda i: results[i].score)
    assert ratios[best] == pytest.approx(true_ratio, abs=1e-3)
    assert results[best].offset / sample_rate == pytest.approx(true_offset, abs=0.05)


def _long_wav(tmp_path, seconds=200.0, rate=12000, seed=3):
    rng = np.random.RandomState(seed)
    spans, t = [], 3.0
    while t < seconds - 4.0:
        length = rng.uniform(0.8, 3.0)
        spans.append((t, t + length))
        t += length + rng.uniform(0.7, 3.0)
    path = str(tmp_path / "ref.wav")
    write_wav(path, speech_signal_for_spans(seconds, spans, rate, speech_level=0.35), rate)
    return path, spans


def test_segment_threads_share_one_device(tmp_path):
    """Four segment threads on one device assemble the same signal as one
    thread, and the same as the JAX package's up to label tolerance."""
    path, _ = _long_wav(tmp_path)
    kw = dict(vad="fused", frame_rate=12000, segment_count=3)
    one = _source(parallel_workers=1, **kw).fit(path).transform()
    four = _source(parallel_workers=4, **kw).fit(path).transform()
    np.testing.assert_array_equal(four, one)
    want = JaxSource(vad="fused", sample_rate=100, frame_rate=12000, non_speech_label=0.0,
                     segment_count=3).fit(path).transform()
    assert one.shape == want.shape
    assert np.mean(np.abs(one - want) < 0.05) >= 0.995
    assert np.array_equal(one == 0, want == 0)  # the same windows sampled


def test_wav_multi_segment_sync_matches_reference(tmp_path):
    """Three disjoint 60 s segments of a 200 s WAV, fused (soft) labels:
    the port's CLI gives the JAX package's offset and scale."""
    path, spans = _long_wav(tmp_path)
    shift = 2.37

    def stamp(x):
        ms = int(round(x * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60, ms % 1000)

    srtin = tmp_path / "in.srt"
    srtin.write_text("".join(
        "%d\n%s --> %s\nline\n\n" % (i + 1, stamp(a - shift), stamp(b - shift))
        for i, (a, b) in enumerate(spans)
    ))
    results = [
        run(make_parser().parse_args(
            [path, "-i", str(srtin), "-o", os.path.join(str(tmp_path), name + ".srt"),
             "--multi-segment-sync", "--segment-count", "3", "--vad", "fused"]))
        for name, run in (("jax", jax_run), ("torch", torch_run))
    ]
    want, got = results
    assert got["sync_was_successful"] and want["sync_was_successful"]
    assert got["offset_seconds"] == pytest.approx(want["offset_seconds"], abs=1e-9)
    assert got["framerate_scale_factor"] == want["framerate_scale_factor"]
    assert got["offset_seconds"] == pytest.approx(shift, abs=0.15)
