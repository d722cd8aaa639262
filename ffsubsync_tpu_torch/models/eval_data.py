# -*- coding: utf-8 -*-
"""Adversarial evaluation audio for the VAD backends.

These generators are deliberately DISJOINT from the training distribution
(models/synth_data.py): speech here is source-filter synthesized (glottal
pulse train / noise excitation shaped by formant resonances in the frequency
domain), not additive harmonic stacks; degradations (µ-law codec, telephone
band-limiting, clipping, low-SNR beds) and hard negatives (applause, crowd
babble, crowd laughter, plucked music) never appear in training. Scoring a
model on these measures transfer, not memorization.

Reference role parity: the reference's VAD value proposition is that
webrtcvad/silero behave sanely on real movie audio
(ffsubsync/speech_transformers.py:101-296); with no real media on this
machine, these conditions stand in for the messy parts of that distribution.

Every generator returns ``(pcm_float32, labels_float32)`` where labels mark
speech presence per analysis window (sample_rate windows per second), plus an
evaluation mask that excludes windows near label transitions (annotation
ambiguity, as in standard VAD scoring).
"""
import zlib
from typing import Callable, Dict, List, Tuple

import numpy as np

Clip = Tuple[np.ndarray, np.ndarray]  # (waveform [-1,1], window labels)


# --------------------------------------------------------------------------
# source-filter speech synthesis (distinct from synth_data's harmonic stacks)
# --------------------------------------------------------------------------


def _spectral_shape(
    x: np.ndarray, frame_rate: int, gain_of_freq: Callable[[np.ndarray], np.ndarray]
) -> np.ndarray:
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / frame_rate)
    return np.fft.irfft(spec * gain_of_freq(freqs), len(x)).astype(np.float32)


def _formant_gain(rng: np.random.RandomState) -> Callable[[np.ndarray], np.ndarray]:
    """Three random formant resonances + glottal spectral tilt."""
    centers = [
        rng.uniform(250, 850),
        rng.uniform(850, 2200),
        rng.uniform(2200, 3200),
    ]
    widths = [rng.uniform(60, 150), rng.uniform(90, 220), rng.uniform(120, 300)]

    def gain(freqs: np.ndarray) -> np.ndarray:
        g = np.zeros_like(freqs)
        for c, w in zip(centers, widths):
            g += np.exp(-0.5 * ((freqs - c) / w) ** 2)
        tilt = 1.0 / (1.0 + (freqs / 3000.0) ** 2)  # ~-12 dB/oct above 3 kHz
        return (0.05 + g) * tilt

    return gain


def _speech_gate(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Utterance on/off mask with phrase-like span statistics."""
    gate = np.zeros(samples, np.float32)
    pos = int(rng.uniform(0.0, 0.8) * frame_rate)
    while pos < samples:
        span = int(rng.uniform(0.5, 2.8) * frame_rate)
        gate[pos : pos + span] = 1.0
        pos += span + int(rng.uniform(0.35, 1.4) * frame_rate)
    return gate


def _syllable_am(rng: np.random.RandomState, t: np.ndarray) -> np.ndarray:
    rate = rng.uniform(3.0, 7.0)
    depth = rng.uniform(0.3, 0.55)
    return (1.0 - depth) + depth * 0.5 * (
        1.0 + np.cos(2 * np.pi * rate * t + rng.uniform(0, 6.28))
    )


def _source_filter_speech(
    rng: np.random.RandomState,
    samples: int,
    frame_rate: int,
    whisper: bool = False,
) -> Clip:
    """Glottal-pulse (or noise, for whisper) excitation through formants."""
    t = np.arange(samples) / frame_rate
    if whisper:
        excitation = rng.randn(samples).astype(np.float32)
    else:
        # pulse train with pitch drift: impulse wherever phase wraps
        f0 = rng.uniform(95, 280)
        drift = 1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t)
        phase = np.cumsum(f0 * drift) / frame_rate
        excitation = np.zeros(samples, np.float32)
        excitation[np.diff(np.floor(phase), prepend=0.0) > 0] = 1.0
        excitation += 0.02 * rng.randn(samples).astype(np.float32)  # breath
    voiced = _spectral_shape(excitation, frame_rate, _formant_gain(rng))
    gate = _speech_gate(rng, samples, frame_rate)
    x = voiced * gate * _syllable_am(rng, t)
    peak = np.max(np.abs(x)) + 1e-9
    return (x / peak * rng.uniform(0.25, 0.6)).astype(np.float32), gate


def _window_labels(gate: np.ndarray, window: int) -> np.ndarray:
    n_windows = len(gate) // window
    per_win = gate[: n_windows * window].reshape(n_windows, window).mean(axis=1)
    return (per_win > 0.5).astype(np.float32)


# --------------------------------------------------------------------------
# degradations
# --------------------------------------------------------------------------


def _mulaw_roundtrip(x: np.ndarray, mu: float = 255.0, levels: int = 256) -> np.ndarray:
    compressed = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    q = np.round((compressed + 1.0) * 0.5 * (levels - 1))
    back = q / (levels - 1) * 2.0 - 1.0
    return (np.sign(back) * ((1 + mu) ** np.abs(back) - 1.0) / mu).astype(
        np.float32
    )


def _bandpass(x: np.ndarray, frame_rate: int, lo: float, hi: float) -> np.ndarray:
    return _spectral_shape(
        x, frame_rate, lambda f: ((f >= lo) & (f <= hi)).astype(np.float64)
    )


def _pink_noise(rng: np.random.RandomState, samples: int, frame_rate: int) -> np.ndarray:
    return _spectral_shape(
        rng.randn(samples).astype(np.float32),
        frame_rate,
        lambda f: 1.0 / np.sqrt(np.maximum(f, 20.0)),
    )


def _scaled_to_snr(
    signal: np.ndarray, noise: np.ndarray, snr_db: float
) -> np.ndarray:
    sig_p = float(np.mean(signal[np.abs(signal) > 1e-6] ** 2) + 1e-12)
    noi_p = float(np.mean(noise**2) + 1e-12)
    target_noi = sig_p / (10.0 ** (snr_db / 10.0))
    return noise * np.sqrt(target_noi / noi_p)


# --------------------------------------------------------------------------
# hard negatives
# --------------------------------------------------------------------------


def _applause(rng: np.random.RandomState, samples: int, frame_rate: int) -> np.ndarray:
    """Dense transient claps: Poisson impulses with short noise decays."""
    x = np.zeros(samples, np.float32)
    n_claps = int(samples / frame_rate * rng.uniform(15, 40))
    decay_len = int(0.01 * frame_rate)
    decay = np.exp(-np.arange(decay_len) / (0.002 * frame_rate))
    for pos in rng.randint(0, samples - decay_len, size=n_claps):
        x[pos : pos + decay_len] += (
            rng.uniform(0.3, 1.0) * decay * rng.randn(decay_len)
        )
    return _spectral_shape(x, frame_rate, lambda f: (f > 400).astype(np.float64))


def _crowd_babble(
    rng: np.random.RandomState, samples: int, frame_rate: int, voices: int = 12
) -> np.ndarray:
    """Many overlapped talkers: individually speech, collectively texture."""
    x = np.zeros(samples, np.float32)
    for _ in range(voices):
        v, _gate = _source_filter_speech(rng, samples, frame_rate)
        x += np.roll(v, rng.randint(samples))
    return x / voices * 3.0


def _crowd_laughter(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Overlapping laugh trains: 4-6 Hz voiced bursts with falling pitch."""
    t = np.arange(samples) / frame_rate
    x = np.zeros(samples, np.float32)
    for _ in range(5):
        burst_rate = rng.uniform(4.0, 6.0)
        burst = (np.sin(2 * np.pi * burst_rate * t + rng.uniform(0, 6.28)) > 0.3)
        f0 = rng.uniform(180, 400) * np.exp(-t / rng.uniform(3.0, 8.0))
        voiced = np.sin(2 * np.pi * np.cumsum(f0) / frame_rate)
        breath = 0.6 * rng.randn(samples)
        x += (voiced + breath) * burst * rng.uniform(0.1, 0.3)
    return _spectral_shape(x, frame_rate, _formant_gain(rng))


def _plucked_music(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Monophonic plucked notes: sharp onsets + exponential decay (onset
    structure that energy detectors mistake for syllables)."""
    x = np.zeros(samples, np.float32)
    scale = 220.0 * 2.0 ** (np.array([0, 2, 4, 5, 7, 9, 11]) / 12.0)
    pos = 0
    while pos < samples - frame_rate // 8:
        note_len = int(rng.uniform(0.15, 0.5) * frame_rate)
        note_len = min(note_len, samples - pos)
        f = float(rng.choice(scale)) * rng.choice([0.5, 1.0, 2.0])
        tt = np.arange(note_len) / frame_rate
        env = np.exp(-tt / rng.uniform(0.08, 0.3))
        note = np.zeros(note_len)
        for h in (1, 2, 3, 5):
            note += np.sin(2 * np.pi * f * h * tt) / h
        x[pos : pos + note_len] += 0.3 * note * env
        pos += note_len
    return x


# Moving-spectrum music: sung vocals, legato strings, orchestral swells.
# Unlike plucked notes (spectrally frozen between onsets), these keep the
# spectrum in continuous motion — vibrato sweeps every harmonic, portamento
# glides between notes, sections cross-fade — which is exactly the property
# the webrtc-class kernel's duty-cycle gate uses to recognize speech. They
# are the likeliest real-world failure family (TV drama scoring, musicals)
# and exist to attack that assumption head-on.


def _melody_f0(
    rng: np.random.RandomState,
    samples: int,
    frame_rate: int,
    base: float,
    note_lo: float,
    note_hi: float,
    glide_s: float,
    vib_rate: Tuple[float, float],
    vib_semitones: Tuple[float, float],
) -> np.ndarray:
    """Per-sample melodic f0: scale-quantized note walk + portamento glides
    between notes + sinusoidal vibrato. The returned contour never freezes:
    vibrato is always on, so every harmonic oscillates continuously."""
    scale_steps = np.array([0, 2, 4, 5, 7, 9, 11, 12], np.float64)
    t = np.arange(samples) / frame_rate
    f0 = np.zeros(samples, np.float64)
    pos = 0
    step = float(rng.choice(scale_steps))
    while pos < samples:
        note_len = int(rng.uniform(note_lo, note_hi) * frame_rate)
        note_len = min(note_len, samples - pos)
        next_step = float(rng.choice(scale_steps)) + rng.choice([-12.0, 0.0, 0.0, 12.0])
        freq = base * 2.0 ** (step / 12.0)
        next_freq = base * 2.0 ** (next_step / 12.0)
        glide = min(int(glide_s * frame_rate), note_len)
        seg = np.full(note_len, freq)
        if glide > 0:
            # portamento into the next note: log-frequency ramp
            ramp = np.linspace(0.0, 1.0, glide)
            seg[note_len - glide :] = freq * (next_freq / freq) ** ramp
        f0[pos : pos + note_len] = seg
        pos += note_len
        step = next_step
    vr = rng.uniform(*vib_rate)
    depth = 2.0 ** (rng.uniform(*vib_semitones) / 12.0) - 1.0
    vibrato = 1.0 + depth * np.sin(2 * np.pi * vr * t + rng.uniform(0, 6.28))
    return (f0 * vibrato).astype(np.float64)


def _harmonic_voice(
    f0: np.ndarray, frame_rate: int, n_harmonics: int, rolloff: float
) -> np.ndarray:
    """Additive harmonic tone following a per-sample f0 contour."""
    phase = 2 * np.pi * np.cumsum(f0) / frame_rate
    x = np.zeros(len(f0), np.float64)
    for h in range(1, n_harmonics + 1):
        x += np.sin(h * phase) / h**rolloff
    return x.astype(np.float32)


def _sung_vocals(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Melodic singing: glottal-pulse-like harmonic source on a sung melody
    (sustained notes, portamento, always-on vibrato) through vowel formant
    filters that change per phrase. Spectrally it IS a voice — harmonics
    through formant resonances — but the phrase-level dynamics are musical:
    long held notes, smooth legato lines, breaths only between phrases."""
    x = np.zeros(samples, np.float32)
    pos = 0
    while pos < samples:
        phrase_len = min(int(rng.uniform(2.5, 6.0) * frame_rate), samples - pos)
        f0 = _melody_f0(
            rng,
            phrase_len,
            frame_rate,
            base=rng.uniform(180.0, 330.0),
            note_lo=0.35,
            note_hi=1.6,
            glide_s=0.09,
            vib_rate=(4.5, 6.5),
            vib_semitones=(0.4, 1.0),
        )
        voice = _harmonic_voice(f0, frame_rate, n_harmonics=12, rolloff=1.0)
        voice = _spectral_shape(voice, frame_rate, _formant_gain(rng))
        # musical phrasing: slow swell in/out, no syllabic AM
        env = np.hanning(2 * phrase_len)[phrase_len:] * 0.3 + 0.7
        fade = min(int(0.12 * frame_rate), phrase_len // 2)
        env[:fade] *= np.linspace(0.0, 1.0, fade)
        env[phrase_len - fade :] *= np.linspace(1.0, 0.0, fade)
        x[pos : pos + phrase_len] = voice * env.astype(np.float32)
        pos += phrase_len + int(rng.uniform(0.15, 0.5) * frame_rate)
    peak = np.max(np.abs(x)) + 1e-9
    return (x / peak * 0.5).astype(np.float32)


def _legato_strings(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Bowed string section: 3 sustained harmonic-rich voices with always-on
    vibrato, long legato notes joined by portamento, and slow bow-pressure
    swells. No onsets, no decays — the spectrum moves continuously and the
    energy envelope barely does."""
    x = np.zeros(samples, np.float64)
    for base in (rng.uniform(130, 180), rng.uniform(260, 340), rng.uniform(390, 520)):
        f0 = _melody_f0(
            rng,
            samples,
            frame_rate,
            base=base,
            note_lo=0.8,
            note_hi=2.6,
            glide_s=0.18,
            vib_rate=(4.8, 6.2),
            vib_semitones=(0.25, 0.6),
        )
        voice = _harmonic_voice(f0, frame_rate, n_harmonics=14, rolloff=0.8)
        # slow independent swells per voice (bow pressure)
        t = np.arange(samples) / frame_rate
        swell = 0.75 + 0.25 * np.sin(
            2 * np.pi * rng.uniform(0.08, 0.25) * t + rng.uniform(0, 6.28)
        )
        x += voice * swell
    # string body: broad low-mid resonance, gentle high rolloff
    shaped = _spectral_shape(
        x.astype(np.float32),
        frame_rate,
        lambda f: (0.3 + np.exp(-0.5 * ((f - 400.0) / 500.0) ** 2))
        / (1.0 + (f / 4000.0) ** 2),
    )
    peak = np.max(np.abs(shaped)) + 1e-9
    return (shaped / peak * 0.5).astype(np.float32)


def _orchestral_bed(
    rng: np.random.RandomState, samples: int, frame_rate: int
) -> np.ndarray:
    """Orchestral scoring bed: legato string section + a glissando line
    sweeping whole octaves + sparse low percussion hits + section-level
    crescendo/decrescendo. Every ingredient keeps the spectrum moving."""
    x = _legato_strings(rng, samples, frame_rate).astype(np.float64)
    t = np.arange(samples) / frame_rate
    # glissando line: continuous log-frequency sweep, direction flips
    n_sweeps = max(1, int(len(t) / frame_rate / rng.uniform(1.5, 3.0)))
    edges = (
        np.sort(rng.uniform(0, samples, n_sweeps - 1).astype(int))
        if n_sweeps > 1
        else np.array([], int)
    )
    targets = rng.uniform(np.log(300.0), np.log(1400.0), n_sweeps + 1)
    knots = np.concatenate([[0], edges, [samples - 1]]).astype(np.float64)
    gliss_f0 = np.exp(np.interp(np.arange(samples, dtype=np.float64), knots, targets))
    gliss = _harmonic_voice(gliss_f0, frame_rate, n_harmonics=6, rolloff=1.2)
    x += 0.4 * gliss
    # timpani-like low hits: 60-90 Hz damped tones, a few per clip
    for _ in range(max(1, int(len(t) / frame_rate / 2.5))):
        pos = rng.randint(0, max(1, samples - frame_rate // 2))
        hit_len = min(int(0.4 * frame_rate), samples - pos)
        tt = np.arange(hit_len) / frame_rate
        f = rng.uniform(60.0, 90.0)
        x[pos : pos + hit_len] += (
            0.8 * np.sin(2 * np.pi * f * tt) * np.exp(-tt / 0.12)
        )
    # section dynamics: slow crescendos
    dyn = 0.6 + 0.4 * np.sin(
        2 * np.pi * rng.uniform(0.05, 0.15) * t + rng.uniform(0, 6.28)
    )
    x *= dyn
    peak = np.max(np.abs(x)) + 1e-9
    return (x / peak * 0.5).astype(np.float32)


# --------------------------------------------------------------------------
# conditions
# --------------------------------------------------------------------------


def _speech_condition(degrade: Callable[..., np.ndarray]):
    def make(rng: np.random.RandomState, samples: int, frame_rate: int, window: int) -> Clip:
        x, gate = _source_filter_speech(rng, samples, frame_rate)
        x = degrade(rng, x, frame_rate)
        x = x + 0.002 * rng.randn(samples).astype(np.float32)
        return x.astype(np.float32), _window_labels(gate, window)

    return make


def _negative_condition(bed: Callable[..., np.ndarray]):
    def make(rng: np.random.RandomState, samples: int, frame_rate: int, window: int) -> Clip:
        x = bed(rng, samples, frame_rate) + 0.002 * rng.randn(samples)
        labels = np.zeros(samples // window, np.float32)
        return x.astype(np.float32), labels

    return make


CONDITIONS: Dict[str, Callable[..., Clip]] = {
    # speech, degraded
    "mulaw_codec": _speech_condition(
        lambda rng, x, fr: _mulaw_roundtrip(x)
    ),
    "telephone_band": _speech_condition(
        lambda rng, x, fr: _bandpass(x, fr, 300.0, 3400.0)
    ),
    "whisper": lambda rng, samples, frame_rate, window: (
        lambda xg: (
            (xg[0] + 0.002 * rng.randn(samples)).astype(np.float32),
            _window_labels(xg[1], window),
        )
    )(_source_filter_speech(rng, samples, frame_rate, whisper=True)),
    "clipped": _speech_condition(
        lambda rng, x, fr: np.clip(x * rng.uniform(4.0, 8.0), -0.5, 0.5)
    ),
    "speech_over_music": _speech_condition(
        lambda rng, x, fr: x
        + _scaled_to_snr(x, _plucked_music(rng, len(x), fr), rng.uniform(3, 9))
    ),
    "low_snr_pink": _speech_condition(
        lambda rng, x, fr: x
        + _scaled_to_snr(x, _pink_noise(rng, len(x), fr), rng.uniform(2, 6))
    ),
    # non-speech, adversarial
    "applause": _negative_condition(_applause),
    "crowd_babble": _negative_condition(_crowd_babble),
    "crowd_laughter": _negative_condition(_crowd_laughter),
    "plucked_music": _negative_condition(_plucked_music),
    # moving-spectrum music: attacks any "speech = spectral motion" premise
    "sung_vocals": _negative_condition(_sung_vocals),
    "legato_strings": _negative_condition(_legato_strings),
    "orchestral": _negative_condition(_orchestral_bed),
}


def evaluation_mask(labels: np.ndarray, margin_windows: int = 15) -> np.ndarray:
    """True where a window counts toward accuracy: windows within
    ``margin_windows`` of a label transition are ambiguous (human annotation
    would disagree there too) and are excluded, as in standard VAD scoring."""
    keep = np.ones(len(labels), bool)
    (edges,) = np.nonzero(np.diff(labels) != 0.0)
    for e in edges:
        keep[max(0, e - margin_windows + 1) : e + 1 + margin_windows] = False
    return keep


MOVIE_SCENARIOS = (
    "clean",
    "mulaw",
    "telephone",
    "noisy",
    "music_bed",
    "applause_breaks",
    "laughter_breaks",
    "babble_breaks",
    # moving-spectrum music families (vibrato/portamento/glissando keep the
    # spectrum in continuous motion, unlike music_bed's frozen plucked notes)
    "vocals_bed",
    "strings_bed",
    "orchestra_bed",
)

# every scenario whose bed is music; the webrtc-class kernel's music bar
# (eval_vad_agreement.check_bars) binds across ALL of these
MUSIC_SCENARIOS = ("music_bed", "vocals_bed", "strings_bed", "orchestra_bed")


def perturbed_movie(
    scenario: str,
    duration_s: float,
    frame_rate: int,
    seed: int = 0,
) -> Tuple[np.ndarray, List[Tuple[float, float]]]:
    """A synthetic movie soundtrack whose true speech timeline is known,
    degraded per ``scenario``. Returns ``(pcm_int16, speech_spans)``.

    Used by the offset-agreement harness: a sync of this movie against
    subtitles whose cues sit at ``speech_spans`` (shifted by a known amount)
    has an unambiguous right answer, so per-``--vad`` offset error is a
    direct end-to-end quality measure.
    """
    if scenario not in MOVIE_SCENARIOS:
        raise ValueError("unknown scenario %r" % (scenario,))
    rng = np.random.RandomState(seed)
    samples = int(duration_s * frame_rate)
    # dialogue spans with movie-like pacing
    spans: List[Tuple[float, float]] = []
    t = rng.uniform(1.0, 3.0)
    while t < duration_s - 6.0:
        length = rng.uniform(1.0, 4.0)
        spans.append((t, t + length))
        t += length + rng.uniform(0.8, 4.0)
    gate = np.zeros(samples, np.float32)
    for a, b in spans:
        gate[int(a * frame_rate) : int(b * frame_rate)] = 1.0
    # speech: source-filter voice through the dialogue gate
    voice, _g = _source_filter_speech(rng, samples, frame_rate)
    tt = np.arange(samples) / frame_rate
    x = voice / (np.max(np.abs(voice)) + 1e-9) * 0.4 * gate * _syllable_am(
        rng, tt
    )
    if scenario == "mulaw":
        x = _mulaw_roundtrip(x)
    elif scenario == "telephone":
        x = _bandpass(x, frame_rate, 300.0, 3400.0)
    elif scenario == "noisy":
        x = x + _scaled_to_snr(x, _pink_noise(rng, samples, frame_rate), 4.0)
    elif scenario == "music_bed":
        x = x + _scaled_to_snr(x, _plucked_music(rng, samples, frame_rate), 6.0)
    elif scenario in ("vocals_bed", "strings_bed", "orchestra_bed"):
        bed_fn = {
            "vocals_bed": _sung_vocals,
            "strings_bed": _legato_strings,
            "orchestra_bed": _orchestral_bed,
        }[scenario]
        x = x + _scaled_to_snr(x, bed_fn(rng, samples, frame_rate), 6.0)
    elif scenario in ("applause_breaks", "laughter_breaks", "babble_breaks"):
        # drop hard negatives into the longer dialogue gaps: a VAD that
        # fires on them corrupts the speech timeline and skews the offset.
        # babble_breaks is the end-to-end expression of the crowd_babble
        # window condition — party scenes between dialogue
        bed_fn = {
            "applause_breaks": _applause,
            "laughter_breaks": _crowd_laughter,
            "babble_breaks": _crowd_babble,
        }[scenario]
        gaps = [
            (b1, a2)
            for (_, b1), (a2, _) in zip(spans[:-1], spans[1:])
            if a2 - b1 > 2.0
        ]
        for g0, g1 in gaps[:: max(1, len(gaps) // 8)]:
            i0 = int((g0 + 0.3) * frame_rate)
            i1 = int((g1 - 0.3) * frame_rate)
            if i1 - i0 < frame_rate // 2:
                continue
            bed = bed_fn(rng, i1 - i0, frame_rate)
            x[i0:i1] += 0.5 * bed / (np.max(np.abs(bed)) + 1e-9)
    x = x + 0.002 * rng.randn(samples).astype(np.float32)
    pcm16 = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    return pcm16, spans


def condition_clips(
    name: str,
    n_clips: int,
    clip_seconds: float,
    frame_rate: int,
    sample_rate: int,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(pcm_int16, labels, eval_mask)] for one named condition."""
    # zlib.crc32 is stable across processes; str hash() is salted per
    # interpreter run and would make the "seeded" eval non-reproducible
    rng = np.random.RandomState((seed ^ zlib.crc32(name.encode())) % (2**31))
    window = frame_rate // sample_rate
    samples = int(clip_seconds * frame_rate)
    out = []
    for _ in range(n_clips):
        x, labels = CONDITIONS[name](rng, samples, frame_rate, window)
        pcm16 = np.clip(x * 32767, -32768, 32767).astype(np.int16)
        out.append((pcm16, labels, evaluation_mask(labels)))
    return out
