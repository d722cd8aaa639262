# -*- coding: utf-8 -*-
"""The port's ``--vad auditok`` detector against the JAX package's: the
tokenizer on drawn validity strings, labels on synthetic speech at every
rate tier and wire, whole-signal tokenization under pipeline chunking, the
unknown-duration spill, and the offset of a 5-minute WAV sync."""
import logging
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ffsubsync_tpu_torch import native
from ffsubsync_tpu.cli import make_parser
from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.ops import vad as jvad
from ffsubsync_tpu.sync import run as jax_run
from ffsubsync_tpu_torch.ops import vad as tvad
from ffsubsync_tpu_torch.sync import run as torch_run

from tests.helpers import write_wav

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPANS = [(1.0, 3.5), (5.0, 6.2), (8.0, 11.0), (12.5, 13.0)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _pcm(rate, duration=14.0, spans=SPANS, level=0.35):
    wav = speech_signal_for_spans(duration, spans, rate, speech_level=level)
    return np.clip(wav * 32767, -32768, 32767).astype(np.int16)


def test_constants_match_reference():
    for name in ("ENERGY_THRESHOLD_DB", "MIN_TOKEN_FACTOR", "MAX_TOKEN_FACTOR",
                 "MAX_SILENCE_FACTOR"):
        assert getattr(tvad, name) == getattr(jvad, name), name


@settings(max_examples=200, deadline=None, database=None)
@given(
    valid=st.lists(st.booleans(), max_size=300),
    min_length=st.integers(1, 12),
    max_length=st.integers(1, 40),
    max_silence=st.integers(0, 10),
)
def test_tokenizer_matches_reference_and_native(valid, min_length, max_length, max_silence):
    valid = np.array(valid, bool)
    want = jvad._tokenize_validity_py(valid, min_length, max_length, max_silence)
    assert tvad._tokenize_validity_py(valid, min_length, max_length, max_silence) == want
    assert tvad.tokenize_validity(valid, min_length, max_length, max_silence) == want
    if native.AVAILABLE:
        assert native.tokenize(valid, min_length, max_length, max_silence) == want


@pytest.mark.parametrize("wire", ["i16", "mulaw", "mulaw6"])
@pytest.mark.parametrize("rate", [8000, 12000, 16000])
def test_labels_equal_reference(monkeypatch, rate, wire):
    monkeypatch.setenv("FFS_TPU_WIRE", wire)
    if wire == "mulaw6":
        # the reference's plain frontend ships i16 under mulaw6 (ROADMAP C7);
        # its Pallas path, in interpret mode here, ships the packed wire
        monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    pcm = _pcm(rate)
    want = np.asarray(jvad.make_auditok_detector(100, rate, 0.0)(pcm))
    got = tvad.make_auditok_detector(100, rate, 0.0, CPU)(pcm)
    assert got.dtype == np.float64 and len(got) == 1400
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_non_speech_label_shaping_equals_reference():
    """The reference's cumsum shaping, quirks included: 0 before the first
    token, and a floor that grows by the label after each token."""
    pcm = _pcm(12000)
    want = np.asarray(jvad.make_auditok_detector(100, 12000, 0.2)(pcm))
    got = tvad.make_auditok_detector(100, 12000, 0.2, CPU)(pcm)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got.max() == 1.0
    assert len(np.unique(got)) > 3


def test_tokens_invariant_to_pipeline_chunking():
    """Port of tests/test_vad.py::test_auditok_tokens_invariant_to_pipeline_
    chunking: dispatch buffers PCM and gather tokenizes the WHOLE signal (a
    token straddling a chunk edge must not split or vanish)."""
    frame_rate = 8000
    pcm = _pcm(frame_rate, 12.0, [(4.0, 6.5), (9.0, 10.0)], level=0.5)
    det = tvad.make_auditok_detector(100, frame_rate, 0.0, CPU)
    whole = det(pcm)
    chunk = frame_rate * 5
    det2 = tvad.make_auditok_detector(100, frame_rate, 0.0, CPU)
    gathered = det2.gather([det2.dispatch_async(pcm[i : i + chunk])
                            for i in range(0, len(pcm), chunk)])
    assert isinstance(gathered, tvad.LazySpeechSignal) and gathered.device == CPU
    np.testing.assert_array_equal(np.asarray(gathered), whole)
    np.testing.assert_array_equal(whole, np.asarray(jvad.make_auditok_detector(100, frame_rate, 0.0)(pcm)))
    assert gathered.padded_values(len(whole) + 5)[: len(whole)].numpy().tolist() == whole.tolist()
    with pytest.raises(ValueError, match="auditok handle"):
        det2.gather([[("other", pcm)]])
    assert len(det2.gather([])) == 0


def _auditok_source(path, rate):
    from ffsubsync_tpu_torch.media.audio import VideoSpeechSource

    src = VideoSpeechSource(vad="auditok", sample_rate=100, frame_rate=rate,
                            non_speech_label=0.0, device=CPU)
    src.fit(path)
    return src


def test_unknown_duration_spill_is_reachable(tmp_path, monkeypatch, caplog):
    """auditok's handles retain PCM, so with no duration the media layer
    must not pipeline: the buffer cap fires even with a pipeline chunk
    shorter than the cap, and the signal streams on."""
    from ffsubsync_tpu_torch.media import audio

    rate = 8000
    spans = [(2.0, 4.0), (8.0, 10.0), (14.0, 16.0)]
    path = str(tmp_path / "ref.wav")
    write_wav(path, speech_signal_for_spans(20.0, spans, rate, speech_level=0.4), rate)
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "2")
    monkeypatch.setenv("FFS_TPU_MAX_BUFFER_BYTES", str(rate * 2 * 5))
    monkeypatch.setattr(audio, "WINDOWS_PER_BUFFER", 300)  # 3 s reads
    monkeypatch.setattr(audio.VideoSpeechSource, "_probe_total_duration", lambda self, f: None)
    with caplog.at_level(logging.INFO, logger=audio.__name__):
        src = _auditok_source(path, rate)
    assert "switching to streaming VAD" in caplog.text
    signal = src.transform()
    assert isinstance(signal, np.ndarray) and len(signal) == 2000
    for s, e in spans:
        assert signal[int(s * 100) + 20 : int(e * 100) - 20].mean() > 0.9


def test_known_duration_pipelines_and_stays_whole(tmp_path, monkeypatch):
    """With a known duration the PCM is dispatched per pipeline chunk and
    tokenized whole at gather: the labels equal one whole-signal call."""
    from ffsubsync_tpu_torch.media import audio

    rate = 8000
    path = str(tmp_path / "ref.wav")
    pcm = _pcm(rate, 12.0, [(4.0, 6.5), (9.0, 10.0)], level=0.5)
    write_wav(path, pcm / 32767.0, rate)
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "5")
    monkeypatch.setattr(audio, "WINDOWS_PER_BUFFER", 250)
    sig = _auditok_source(path, rate).signal_or_spec()
    assert isinstance(sig, tvad.LazySpeechSignal)
    whole = tvad.make_auditok_detector(100, rate, 0.0, CPU)(pcm)
    np.testing.assert_array_equal(sig.materialize(), whole)


@pytest.mark.parametrize("vad,known", [("auditok", True), ("auditok", False),
                                       ("webrtc", True), ("fused", True)])
def test_reference_shorter_than_a_chunk_keeps_labels_on_device(tmp_path, monkeypatch, vad, known):
    """A buffered reference shorter than one pipeline chunk is one dispatch
    of the whole buffer: its labels reach the aligner as a
    ``LazySpeechSignal`` on the source's device, equal to one detector call
    on the whole signal, whether or not the duration is known."""
    from ffsubsync_tpu_torch.media import audio

    rate = 8000
    path = str(tmp_path / "ref.wav")
    pcm = _pcm(rate, 12.0, [(4.0, 6.5), (9.0, 10.0)], level=0.5)
    write_wav(path, pcm / 32767.0, rate)
    monkeypatch.setattr(audio, "WINDOWS_PER_BUFFER", 250)
    if not known:
        monkeypatch.setattr(audio.VideoSpeechSource, "_probe_total_duration", lambda self, f: None)
    src = audio.VideoSpeechSource(vad=vad, sample_rate=100, frame_rate=rate,
                                  non_speech_label=0.0, device=CPU)
    sig = src.fit(path).signal_or_spec()
    assert isinstance(sig, tvad.LazySpeechSignal) and sig.device == CPU
    whole = tvad.make_detector(vad, 100, rate, 0.0, CPU)(pcm)
    np.testing.assert_array_equal(sig.materialize(), whole)


def test_five_minute_wav_offset_equals_reference(tmp_path):
    """ROADMAP C1: the reference's energy VAD carries an onset bias; the
    port reproduces the reference's offset exactly, bias and all."""
    rate = 12000
    rng = np.random.RandomState(5)
    spans, t = [], 4.0
    while t < 290.0:
        length = rng.uniform(0.8, 3.5)
        spans.append((t, t + length))
        t += length + rng.uniform(0.6, 3.0)
    path = str(tmp_path / "ref.wav")
    write_wav(path, speech_signal_for_spans(300.0, spans, rate, speech_level=0.35), rate)
    shift = 3.21

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
             "--vad", "auditok"]))
        for name, run in (("jax", jax_run), ("torch", torch_run))
    ]
    want, got = results
    assert got == want
    assert got["sync_was_successful"]
    assert got["offset_seconds"] == pytest.approx(shift, abs=0.15)
    assert (tmp_path / "torch.srt").read_text() == (tmp_path / "jax.srt").read_text()
