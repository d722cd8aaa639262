# -*- coding: utf-8 -*-
"""Synthetic speech with a known timeline, for ``chip_smoke.py`` and the
tests: :func:`speech_signal_for_spans` and the generator it calls, verbatim
copies of ``ffsubsync_tpu/models/synth_data.py``'s. The training data
generators of that module come with the port of training.
"""
from typing import List, Tuple

import numpy as np


def speech_signal_for_spans(
    duration_s: float,
    speech_spans: List[Tuple[float, float]],
    frame_rate: int = 48000,
    seed: int = 0,
    speech_level: float = 0.3,
    noise_level: float = 0.002,
) -> np.ndarray:
    """Waveform with speech-like audio exactly inside the given spans.

    Used by benchmarks and integration tests to fabricate media whose true
    speech timeline is known. The per-span audio is pulse-train speech with
    CONTINUOUSLY moving formants (:func:`_moving_formant_speech`): real
    dialogue glides pitch and formants through every syllable, and the
    webrtc-class detector's spectral-motion gate (ops/vad.py) keys on
    exactly that — a static harmonic stack here would be, spectrally, a
    sustained music note.
    """
    rng = np.random.RandomState(seed)
    n = int(duration_s * frame_rate)
    t = np.arange(n) / frame_rate
    x = rng.randn(n).astype(np.float32) * noise_level
    for (start, end) in speech_spans:
        i0, i1 = int(start * frame_rate), min(int(end * frame_rate), n)
        if i1 <= i0:
            continue
        seg_t = t[i0:i1]
        seg = _moving_formant_speech(rng, i1 - i0, frame_rate)
        # Syllable-rate AM, phase-anchored so the envelope PEAKS at the span
        # start: the truth label says speech begins here, and real utterances
        # lead with a stressed syllable. A random phase can open the span at
        # ~10% amplitude, which skews every energy detector's onset by tens
        # of ms — a fixture artifact, not a detector defect (the same trap as
        # Hann-faded edges; see the fixture-realism note in _moving_formant_
        # speech's OLA handling).
        am_phase = np.pi / 2 - 2 * np.pi * 4.0 * seg_t[0]
        am = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * seg_t + am_phase)
        x[i0:i1] += speech_level * seg * am.astype(np.float32)
    return x


def _moving_formant_speech(rng, samples: int, frame_rate: int) -> np.ndarray:
    """Pulse-train excitation through continuously moving formants.

    Unlike :func:`_pulse_train_vowels` (whose filter is constant within each
    vowel segment), the formant filter here is re-drawn per 80 ms hop as a
    random walk between vowel targets and applied by Hann overlap-add, so
    adjacent hops CROSSFADE — every 10 ms analysis window sees a spectrum
    in motion, as real articulation does. Pitch adds a phrase-scale glide
    on top of slow wander.
    """
    t = np.arange(samples) / frame_rate
    f0 = rng.uniform(100, 260)
    glide = 1.0 + rng.uniform(0.15, 0.3) * np.sin(
        2 * np.pi * rng.uniform(0.6, 1.6) * t + rng.uniform(0, 6.28)
    )
    wander = 1.0 + 0.04 * np.cumsum(rng.randn(samples)) / np.sqrt(samples)
    phase = np.cumsum(f0 * glide * wander) / frame_rate
    frac = phase - np.floor(phase)
    sharp = rng.uniform(150.0, 450.0)
    excitation = np.exp(-sharp * (frac - 0.08) ** 2).astype(np.float32)
    # per-period shimmer: real glottal pulses vary in amplitude, which
    # varies the windowed spectrum pulse to pulse (spectral motion a
    # constant-amplitude pulse train lacks)
    period_idx = np.floor(phase).astype(int)
    shimmer = 1.0 + 0.3 * rng.randn(period_idx.max() + 1)
    excitation *= shimmer[period_idx].astype(np.float32)
    excitation += rng.uniform(0.06, 0.12) * rng.randn(samples).astype(np.float32)
    hop = max(int(0.06 * frame_rate), 2)
    win = np.hanning(2 * hop).astype(np.float32)
    # Synthesize one extra hop of (discarded) signal on each side so every
    # RETAINED sample sits where adjacent Hann windows overlap-add to
    # exactly 1. Without the margin the first/last hop has wsum -> 0, and
    # dividing it out amplifies the filter's circular-convolution leakage
    # (not proportional to the window) into a full-scale edge spike that
    # the final peak normalization then uses to squash the actual speech.
    total = samples + 2 * hop
    excitation = np.pad(excitation, (hop, hop), mode="reflect")
    out = np.zeros(total + 2 * hop, np.float32)
    wsum = np.zeros(total + 2 * hop, np.float32)
    freqs = np.fft.rfftfreq(2 * hop, 1.0 / frame_rate)
    centers = np.array(
        [rng.uniform(300, 800), rng.uniform(900, 2200), rng.uniform(2300, 3200)]
    )
    lo_c = np.array([250.0, 850.0, 2200.0])
    hi_c = np.array([850.0, 2300.0, 3400.0])
    for s in range(total // hop + 1):
        i0 = s * hop
        seg = excitation[i0 : i0 + 2 * hop]
        if len(seg) < 2 * hop:
            seg = np.pad(seg, (0, 2 * hop - len(seg)))
        # reflecting random walk in log-frequency: clipping would let a
        # formant stick at a bound for many hops (a frozen filter — the
        # exact spectral signature of a held note, not of articulation)
        log_pos = np.log(centers) + rng.uniform(-0.3, 0.3, size=3)
        lo_l, hi_l = np.log(lo_c), np.log(hi_c)
        span_l = hi_l - lo_l
        folded = np.mod(log_pos - lo_l, 2.0 * span_l)
        folded = np.where(folded > span_l, 2.0 * span_l - folded, folded)
        centers = np.exp(lo_l + folded)
        gain = np.full_like(freqs, 0.03)
        for c, rel_bw in zip(centers, (0.12, 0.14, 0.18)):
            gain = gain + np.exp(-0.5 * ((freqs - c) / (rel_bw * c)) ** 2)
        gain *= 1.0 / (1.0 + (freqs / 3000.0) ** 2)
        out[i0 : i0 + 2 * hop] += np.fft.irfft(
            np.fft.rfft(seg * win) * gain, 2 * hop
        ).astype(np.float32)
        wsum[i0 : i0 + 2 * hop] += win
    # dividing out the window-sum envelope keeps utterance edges sharp: the
    # first/last hop would otherwise Hann-fade, shifting every energy
    # detector's onsets by a consistent few tens of ms. The retained span
    # lies entirely in the full-overlap region (wsum == 1 up to rounding),
    # so this is exact, never an edge amplification.
    out = out[hop : hop + samples] / np.maximum(wsum[hop : hop + samples], 0.5)
    peak = float(np.max(np.abs(out))) + 1e-9
    return (out / peak).astype(np.float32)
