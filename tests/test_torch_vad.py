# -*- coding: utf-8 -*-
"""Port detectors (one ``_vad_program`` per chunk) against the JAX
package's one-launch program (``_vad_program``, Pallas in interpret mode)
for every ``--vad`` mode, single-chunk and chunked; the port's chunk
plumbing (async dispatch, carried state, lazy labels) on its own."""
import numpy as np
import pytest
import torch

from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu.ops import vad as jvad
from ffsubsync_tpu_torch.ops import vad as tvad

torch.set_num_threads(1)

RATE = 12000
CPU = torch.device("cpu")
MODES = ["webrtc", "silero", "fused", "fused:intersection", "fused:union"]
# the reference's own device bar (tests/test_tpu_smoke.py): continuous
# labels within 0.05 on >= 99.5% of windows
LABEL_TOL, LABEL_AGREEMENT = 0.05, 0.995


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def pcm():
    spans = [(1.0, 3.5), (5.0, 6.2), (8.0, 11.0)]
    wav = speech_signal_for_spans(14.0, spans, RATE, speech_level=0.35)
    return np.clip(wav * 32767, -32768, 32767).astype(np.int16)


def _assert_labels_agree(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    agree = np.mean(np.abs(got - want) < LABEL_TOL)
    assert agree >= LABEL_AGREEMENT, agree


@pytest.mark.parametrize("chunk_seconds", ["0", "6"])
@pytest.mark.parametrize("mode", MODES)
def test_labels_match_reference_program(monkeypatch, pcm, mode, chunk_seconds):
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", chunk_seconds)
    want = np.asarray(jvad.make_detector(mode, 100, RATE, 0.0)(pcm))
    got = tvad.make_detector(mode, 100, RATE, 0.0, CPU)(pcm)
    assert len(got) == 1400
    _assert_labels_agree(got, want)


@pytest.mark.parametrize("mode", ["webrtc", "fused"])
def test_nonzero_non_speech_label(pcm, mode):
    want = np.asarray(jvad.make_detector(mode, 100, RATE, 0.2)(pcm))
    got = tvad.make_detector(mode, 100, RATE, 0.2, CPU)(pcm)
    _assert_labels_agree(got, want)
    assert got.min() >= 0.2 - 1e-6


@pytest.mark.parametrize("mode", ["webrtc", "silero", "fused"])
def test_async_dispatch_equals_call_and_manual_chunks(monkeypatch, pcm, mode):
    """``dispatch_async`` + ``gather`` is the same computation as calling
    the detector, and the carried state makes one chunked call equal to
    feeding the same chunks by hand."""
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "6")
    called = tvad.make_detector(mode, 100, RATE, 0.0, CPU)(pcm)
    det = tvad.make_detector(mode, 100, RATE, 0.0, CPU)
    lazy = det.gather([det.dispatch_async(pcm)])
    assert isinstance(lazy, tvad.LazySpeechSignal)
    np.testing.assert_array_equal(lazy.materialize(), called)
    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "0")
    det = tvad.make_detector(mode, 100, RATE, 0.0, CPU)
    step = 6 * RATE
    manual = np.concatenate([det(pcm[i : i + step]) for i in range(0, len(pcm), step)])
    np.testing.assert_array_equal(manual, called)


def test_padded_frames_do_not_change_valid_labels(pcm):
    """Rows past n_valid (bucket padding in the reference) are inert."""
    from ffsubsync_tpu_torch.models.neural_vad import load_net
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    framed, rate, window, n = prepare_staged_input(pcm, RATE, 100)
    net = load_net(rate, CPU)
    padded = np.zeros((n + 300, framed.shape[1]), framed.dtype)
    padded[:n] = framed
    outs = [
        tvad._vad_program(
            torch.from_numpy(f), window, rate, n, tvad.initial_state(CPU), net, 0.0, "weighted"
        )
        for f in (framed, padded)
    ]
    np.testing.assert_allclose(outs[1][0][:n].numpy(), outs[0][0].numpy(), atol=1e-5)
    for key, value in outs[0][1].items():
        other = outs[1][1][key]
        if isinstance(value, torch.Tensor):
            np.testing.assert_allclose(other.numpy(), value.numpy(), rtol=1e-5, atol=1e-6)
        else:
            assert other == value, key


def test_lazy_speech_signal():
    parts = [(torch.tensor([1.0, 0.0, 1.0, 9.0]), 3), (torch.tensor([0.5, 0.25]), 2)]
    sig = tvad.LazySpeechSignal(parts + [(torch.tensor([7.0]), 0)])
    assert len(sig) == 5
    assert sig.device == CPU
    np.testing.assert_array_equal(
        sig.padded_values(8).numpy(), [1.0, 0.0, 1.0, 0.5, 0.25, 0.0, 0.0, 0.0]
    )
    assert sig.sum() == pytest.approx(2.75)
    out = np.asarray(sig)
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, [1.0, 0.0, 1.0, 0.5, 0.25])
    with pytest.raises(ValueError):
        sig.padded_values(4)


def test_detector_errors(pcm):
    # auditok (ported) routes as in the reference, prefix and all
    want = np.asarray(jvad.make_detector("auditok", 100, RATE, 0.0)(pcm))
    for name in ("auditok", "subs_then_auditok"):
        det = tvad.make_detector(name, 100, RATE, 0.0, CPU)
        assert det.buffers_pcm
        np.testing.assert_array_equal(det(pcm), want)
    with pytest.raises(ValueError):
        tvad.make_detector("fused:bogus", 100, RATE, 0.0, CPU)
    with pytest.raises(ValueError):
        tvad.make_detector("nonsense", 100, RATE, 0.0, CPU)
    assert len(tvad.make_detector("webrtc", 100, RATE, 0.0, CPU)(np.zeros(0, np.int16))) == 0


def test_pipeline_chunk_samples_matches_reference(monkeypatch):
    for seconds in ("2700", "6", "0"):
        monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", seconds)
        for rate in (8000, 12000, 48000):
            assert tvad._pipeline_chunk_samples(rate, 100) == jvad._pipeline_chunk_samples(rate, 100)
