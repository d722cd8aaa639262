# -*- coding: utf-8 -*-
"""End-to-end: the port's ``run()`` against the JAX package's ``run()`` on
the WAV cases of tests/test_audio_e2e.py (synthetic speech whose spans
match REF_SRT, subtitles shifted by a known offset), plus the lazy device
signal at the aligner and the host-only reference kinds."""
import os

import numpy as np
import pytest
import torch

from ffsubsync_tpu.cli import make_parser
from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.sync import run as jax_run
from ffsubsync_tpu_torch.sync import run as torch_run

from tests.helpers import spans_from_srt_text, write_wav
from tests.test_sync_e2e import REF_SRT, _make_unsynced, _write

torch.set_num_threads(1)

RATE = 12000  # the analysis tier: the WAV is read at its own rate


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _make_media(tmp_path):
    spans = spans_from_srt_text(REF_SRT)
    wav = speech_signal_for_spans(max(e for _, e in spans) + 3.0, spans, RATE, speech_level=0.35)
    path = os.path.join(str(tmp_path), "ref.wav")
    write_wav(path, wav, RATE)
    return path


@pytest.mark.parametrize(
    "vad, offset",
    [("webrtc", 2.2), ("silero", 2.2), ("fused", 2.2), ("auditok", 2.2), (None, -1.4)],
)
def test_wav_sync_matches_reference(tmp_path, vad, offset):
    media = _make_media(tmp_path)
    srtin = _make_unsynced(tmp_path, _write(tmp_path, "truth.srt", REF_SRT), offset)
    results = []
    for name, run in (("jax", jax_run), ("torch", torch_run)):
        argv = [media, "-i", srtin, "-o", os.path.join(str(tmp_path), name + ".srt")]
        results.append(run(make_parser().parse_args(argv + (["--vad", vad] if vad else []))))
    want, got = results
    assert got["sync_was_successful"] == want["sync_was_successful"] is True
    assert got["offset_seconds"] == pytest.approx(want["offset_seconds"], abs=0.01)
    assert got["framerate_scale_factor"] == want["framerate_scale_factor"]
    for r in results:
        assert r["offset_seconds"] == pytest.approx(offset, abs=0.15)


def test_audio_signal_reaches_aligner_as_lazy_labels(tmp_path, monkeypatch):
    """The pipeline hands the aligner the port's lazy device signal, and it
    aligns exactly as its materialized host values do."""
    from ffsubsync_tpu_torch.subs.raster import rasterize_intervals
    from ffsubsync_tpu_torch.media.audio import VideoSpeechSource
    from ffsubsync_tpu_torch.ops.align import align_candidates
    from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "6")
    spans = [(2.0, 4.5), (8.0, 11.0), (14.0, 16.0)]
    wav = speech_signal_for_spans(20.0, spans, 8000, speech_level=0.35)
    path = str(tmp_path / "m.wav")
    write_wav(path, wav, 8000)
    src = VideoSpeechSource(
        vad="webrtc", sample_rate=100, frame_rate=8000, non_speech_label=0.0,
        device=torch.device("cpu"),
    )
    src.fit(path)
    sig = src.signal_or_spec()
    assert isinstance(sig, LazySpeechSignal) and len(sig) == 2000
    assert not src.prefer_host_align
    shift = 1.5
    cand = rasterize_intervals([(a - shift, b - shift) for a, b in spans], 100)
    lazy = align_candidates(sig, [cand], max_offset_samples=500)[0]
    host = align_candidates(sig.materialize(), [cand], 500, device=torch.device("cpu"))[0]
    assert lazy.offset == host.offset
    assert abs(lazy.offset - int(shift * 100)) <= 1
    assert lazy.score == pytest.approx(host.score, rel=1e-5)
    out = src.transform()
    assert isinstance(out, np.ndarray) and out.dtype == np.float64


def test_srt_reference_sync_matches_reference(tmp_path):
    """Subtitle references stay on the host, as in the reference: the port
    needs no device for them (even one that is not there)."""
    ref = _write(tmp_path, "ref.srt", REF_SRT)
    srtin = _make_unsynced(tmp_path, ref, 2.5)
    results = [
        run(make_parser().parse_args([ref, "-i", srtin, "-o", str(tmp_path / (n + ".srt")), "--gss"]))
        for n, run in (("jax", jax_run), ("torch", torch_run))
    ]
    assert results[0] == results[1]
    assert results[1]["offset_seconds"] == pytest.approx(2.5, abs=0.02)


def test_multi_segment_sync_is_not_ported_yet(tmp_path):
    """``--multi-segment-sync`` through the CLI gives the JAX package's
    result dict. (The name dates from when the port refused this path; it
    is kept so the test's history stays one test.) One segment: on this 67 s WAV more segments
    would overlap, and overlapping segments land in completion order in
    both packages (ROADMAP C8); tests/test_torch_segments.py syncs disjoint
    ones. Fused labels are soft, so the score has no exact-tie plateau whose
    pick f32 FFT rounding would decide (ROADMAP C4)."""
    media = _make_media(tmp_path)
    srtin = _make_unsynced(tmp_path, _write(tmp_path, "truth.srt", REF_SRT), 1.0)
    results = [
        run(make_parser().parse_args(
            [media, "-i", srtin, "-o", str(tmp_path / (n + ".srt")), "--multi-segment-sync",
             "--segment-count", "1", "--vad", "fused"]))
        for n, run in (("jax", jax_run), ("torch", torch_run))
    ]
    want, got = results
    assert got["sync_was_successful"] and want["sync_was_successful"]
    assert got["offset_seconds"] == pytest.approx(want["offset_seconds"], abs=0.01)
    assert got["framerate_scale_factor"] == want["framerate_scale_factor"]
    assert got["offset_seconds"] == pytest.approx(1.0, abs=0.15)


def test_profile_dir_writes_a_torch_trace(tmp_path):
    ref = _write(tmp_path, "ref.srt", REF_SRT)
    srtin = _make_unsynced(tmp_path, ref, 1.0)
    prof = tmp_path / "prof"
    result = torch_run(
        make_parser().parse_args([ref, "-i", srtin, "-o", str(tmp_path / "o.srt"),
                                  "--profile-dir", str(prof)])
    )
    assert result["sync_was_successful"]
    assert (prof / "trace.json").stat().st_size > 0


def test_buffered_vad_spills_to_streaming_when_cap_exceeded(tmp_path, monkeypatch):
    """With a buffer cap far below the file, the buffered path drains
    through the state-carrying detector and keeps streaming; the signal is
    full length and finds every span."""
    from ffsubsync_tpu_torch.media.audio import VideoSpeechSource

    spans = [(2.0, 4.0), (8.0, 10.0), (14.0, 16.0)]
    path = str(tmp_path / "ref.wav")
    write_wav(path, speech_signal_for_spans(20.0, spans, 16000, speech_level=0.4), 16000)
    monkeypatch.setenv("FFS_TPU_MAX_BUFFER_BYTES", str(16000 * 2 * 5))
    src = VideoSpeechSource(
        vad="webrtc", sample_rate=100, frame_rate=16000, non_speech_label=0.0,
        device=torch.device("cpu"),
    )
    src.fit(path)
    signal = src.transform()
    assert len(signal) == 20 * 100
    for s, e in spans:
        assert signal[int(s * 100) + 20 : int(e * 100) - 20].mean() > 0.4


def test_wav_gss_sync_matches_reference(tmp_path):
    """--gss on an audio reference: three 33-ratio rounds on the device."""
    media = _make_media(tmp_path)
    srtin = _make_unsynced(tmp_path, _write(tmp_path, "truth.srt", REF_SRT), 1.3)
    results = [
        run(make_parser().parse_args(
            [media, "-i", srtin, "-o", str(tmp_path / (n + ".srt")), "--vad", "webrtc", "--gss"]
        ))
        for n, run in (("jax", jax_run), ("torch", torch_run))
    ]
    want, got = results
    assert got["sync_was_successful"] and want["sync_was_successful"]
    assert got["offset_seconds"] == pytest.approx(want["offset_seconds"], abs=0.01)
    assert got["framerate_scale_factor"] == pytest.approx(want["framerate_scale_factor"], abs=1e-6)
    assert got["offset_seconds"] == pytest.approx(1.3, abs=0.15)
