# -*- coding: utf-8 -*-
"""Synthetic audio generation for training/benchmarking the neural VAD.

Speech is synthesized in several modes so the learned detector keys on the
*class* of cues (harmonicity + syllable-rate envelope structure) rather than
one generator's quirks:

- ``formant``: jittered-pitch harmonic stack shaped by random formant peaks;
- ``stable``: clean 1/h harmonic stack with sinusoidal syllabic AM and a
  random modulation floor (some talkers barely modulate);
- ``fricative``: noise bursts band-passed into speech bands mixed with a weak
  voiced component (consonant-heavy speech);
- ``source-filter``: rounded glottal-pulse excitation shaped by formant
  resonances that move between vowel targets — broadband excitation whose
  spectrum comes from the filter, covering the class of speech that additive
  stacks miss (and the class real vocoders/codecs produce).

Non-speech: silence/noise beds, steady tones, music-like sustained harmonic
chords (energetic but not syllabically modulated), plus adversarial classes
that share individual speech cues without being speech — transient trains
(claps/foley), decaying note onsets, crowd babble (overlapped talkers), and
laughter-class periodic voiced bursts. The adversarial *evaluation* set
(models/eval_data.py) covers the same classes with disjoint generators.

Labels mark whole utterance spans (as human VAD annotations do), not the
instantaneous envelope — the detector is expected to bridge syllabic dips.
"""
from typing import List, Tuple

import numpy as np


def _utterance_mask(rng, samples, frame_rate) -> np.ndarray:
    active = np.zeros(samples, np.float32)
    pos = 0
    while pos < samples:
        burst = int(rng.uniform(0.3, 3.5) * frame_rate)
        gap = int(rng.uniform(0.2, 1.5) * frame_rate)
        active[pos: pos + burst] = 1.0
        pos += burst + gap
    return active


def _syllabic_am(rng, t) -> np.ndarray:
    depth = rng.uniform(0.25, 0.6)
    return (1.0 - depth) + depth * np.sin(
        2 * np.pi * rng.uniform(2, 8) * t + rng.uniform(0, 6.28)
    )


def _pulse_train_vowels(rng, samples: int, frame_rate: int) -> np.ndarray:
    """Source-filter-class speech: rounded glottal pulses through formant
    resonances that *move* between vowel-like targets every fraction of a
    second. A different family than the additive harmonic stacks below —
    broadband excitation whose spectrum is imposed by the filter, not a sum
    of weighted sinusoids.
    """
    t = np.arange(samples) / frame_rate
    # excitation: one rounded pulse per pitch period (random-walk pitch)
    f0 = rng.uniform(90, 290)
    wander = 1.0 + 0.03 * np.cumsum(rng.randn(samples)) / np.sqrt(samples)
    phase = np.cumsum(f0 * wander) / frame_rate
    frac = phase - np.floor(phase)
    sharp = rng.uniform(60.0, 180.0)  # pulse sharpness (open-quotient-ish)
    excitation = np.exp(-sharp * (frac - 0.08) ** 2).astype(np.float32)
    excitation += rng.uniform(0.01, 0.06) * rng.randn(samples).astype(np.float32)
    # filter: time-varying formants, re-sampled per vowel-length segment
    out = np.zeros(samples, np.float32)
    freqs = None
    pos = 0
    while pos < samples:
        seg_len = min(int(rng.uniform(0.15, 0.6) * frame_rate), samples - pos)
        seg = excitation[pos : pos + seg_len]
        spec = np.fft.rfft(seg)
        if freqs is None or len(freqs) != len(spec):
            freqs = np.fft.rfftfreq(seg_len, 1.0 / frame_rate)
        gain = np.full_like(freqs, 0.04)
        for lo, hi in ((280, 900), (900, 2300), (2300, 3400)):
            c = rng.uniform(lo, hi)
            bw = rng.uniform(0.08, 0.22) * c
            gain = gain + np.exp(-0.5 * ((freqs - c) / bw) ** 2)
        gain *= 1.0 / (1.0 + (freqs / rng.uniform(2000.0, 4000.0)) ** 1.7)
        out[pos : pos + seg_len] = np.fft.irfft(spec * gain, seg_len)
        pos += seg_len
    peak = float(np.max(np.abs(out))) + 1e-9
    return (out / peak).astype(np.float32)


def _impulse_static_resonator(rng, samples: int, frame_rate: int) -> np.ndarray:
    """Hard glottal impulses through formants FIXED for the whole clip.

    A fourth texture axis for the speech families here: `_pulse_train_vowels`
    and `_moving_formant_speech` move their filters (articulation), but one
    talker heard over seconds also presents near-static resonances — a single
    vocal tract holding a flat read. The excitation is a true impulse train
    (the brightest glottal source) with slow pitch drift; the filter is three
    fixed Gaussian resonances plus a low-pass tilt, applied in one FFT pass
    over the clip; the output is peak-normalized. Crowd babble built from
    voices like these has a quasi-stationary aggregate spectrum carrying only
    per-voice syllabic AM — a texture the moving-formant families never
    produce, and exactly the transfer gap the round-4 babble probe measured
    (scripts/probe_babble_ceiling.py: in-distribution oracle 1.00 vs shipped
    0.64 on held-out eval babble windows).
    """
    t = np.arange(samples) / frame_rate
    f0 = rng.uniform(95, 285)
    drift = 1.0 + rng.uniform(0.02, 0.08) * np.sin(
        2 * np.pi * rng.uniform(0.15, 1.2) * t + rng.uniform(0, 6.28)
    )
    phase = np.cumsum(f0 * drift) / frame_rate
    excitation = np.zeros(samples, np.float32)
    excitation[np.diff(np.floor(phase), prepend=0.0) > 0] = 1.0
    excitation += rng.uniform(0.01, 0.05) * rng.randn(samples).astype(
        np.float32
    )
    spec = np.fft.rfft(excitation)
    freqs = np.fft.rfftfreq(samples, 1.0 / frame_rate)
    gain = np.full_like(freqs, rng.uniform(0.03, 0.08))
    for lo, hi in ((250, 900), (850, 2300), (2200, 3300)):
        c = rng.uniform(lo, hi)
        w = rng.uniform(0.07, 0.2) * c
        gain = gain + np.exp(-0.5 * ((freqs - c) / w) ** 2)
    gain *= 1.0 / (1.0 + (freqs / rng.uniform(2500.0, 3500.0)) ** 2)
    out = np.fft.irfft(spec * gain, samples).astype(np.float32)
    peak = float(np.max(np.abs(out))) + 1e-9
    return (out / peak).astype(np.float32)


def synth_speech(rng, samples: int, frame_rate: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (waveform, active_mask) for one speech clip."""
    t = np.arange(samples) / frame_rate
    mode = rng.randint(5)
    f0 = rng.uniform(90, 300)
    if mode == 0:  # formant-weighted, jittered pitch
        jitter = 1.0 + 0.01 * np.cumsum(rng.randn(samples)) / np.sqrt(samples)
        phase = 2 * np.pi * f0 * t * jitter
        voiced = np.zeros(samples, np.float32)
        for h in range(1, 12):
            formant_gain = np.exp(
                -0.5 * ((h * f0 - rng.choice([500, 1500, 2500])) / 600.0) ** 2
            ) + 0.15
            voiced += formant_gain / h * np.sin(h * phase + rng.uniform(0, 6.28))
    elif mode == 1:  # stable harmonic stack
        voiced = np.zeros(samples, np.float32)
        for h in range(1, 10):
            voiced += (1.0 / h) * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)
            ).astype(np.float32)
    elif mode == 2:  # fricative-heavy: band-passed noise + weak voiced component
        noise = rng.randn(samples).astype(np.float32)
        spec = np.fft.rfft(noise)
        freqs = np.fft.rfftfreq(samples, 1.0 / frame_rate)
        band = (freqs > 1500) & (freqs < 6000)
        spec[~band] *= 0.05
        voiced = np.fft.irfft(spec, samples).astype(np.float32) * 3.0
        for h in range(1, 5):
            voiced += (0.4 / h) * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)
            ).astype(np.float32)
    elif mode == 3:  # source-filter family: pulse excitation, moving formants
        voiced = _pulse_train_vowels(rng, samples, frame_rate)
    else:  # static-resonator family: impulse train, fixed formants
        voiced = _impulse_static_resonator(rng, samples, frame_rate)
    active = _utterance_mask(rng, samples, frame_rate)
    level = 10 ** rng.uniform(-1.5, -0.3)
    envelope = _syllabic_am(rng, t) * active * level
    return (voiced * envelope).astype(np.float32), active


def _reverb(rng, x: np.ndarray, frame_rate: int) -> np.ndarray:
    """Cheap room: a few decaying echo taps."""
    out = x.copy()
    for _ in range(rng.randint(2, 5)):
        delay = int(rng.uniform(0.01, 0.08) * frame_rate)
        gain = rng.uniform(0.1, 0.4)
        out[delay:] += gain * x[: len(x) - delay]
    return out


def _negative_mode(rng) -> int:
    """Weighted non-speech class draw. Babble and laughter dominate: they
    share the most cues with dialogue (voiced, formant-shaped, modulated)
    and are where a VAD that over-recalls noisy speech fails hardest.
    Moving-spectrum music gets its own slot: its continuously-gliding
    harmonics defeat any 'spectral motion = speech' shortcut."""
    u = rng.rand()
    if u < 0.27:
        return 6  # crowd babble
    if u < 0.45:
        return 7  # laughter-class burst trains
    if u < 0.56:
        return 4  # transient trains
    if u < 0.67:
        return 5  # note onsets
    if u < 0.82:
        return 3  # moving-spectrum sustained music
    return rng.randint(3)  # benign beds: silence/tones/chords


def synth_nonspeech(rng, samples: int, frame_rate: int, mode=None) -> np.ndarray:
    t = np.arange(samples) / frame_rate
    if mode is None:
        mode = _negative_mode(rng)
    x = np.zeros(samples, np.float32)
    if mode == 0:
        pass  # noise floor only (added by caller)
    elif mode == 1:  # steady tone(s)
        for _ in range(rng.randint(1, 4)):
            f = rng.uniform(100, 4000)
            x += (10 ** rng.uniform(-1.5, -0.5)) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 6.28)
            ).astype(np.float32)
    elif mode == 2:  # music-like sustained harmonic chords
        seg = samples // 4
        for s in range(4):
            base = rng.choice([110, 147, 196, 262])
            for h in (1, 2, 3, 4):
                x[s * seg:(s + 1) * seg] += (
                    10 ** rng.uniform(-1.8, -0.8) / h
                    * np.sin(2 * np.pi * base * h * t[:seg])
                ).astype(np.float32)
    elif mode == 3:  # moving-spectrum music: sustained voices whose spectra
        # NEVER freeze — vibrato sweeps every harmonic, the pitch contour is
        # a smoothed random walk (portamento-like glides, no note grid), and
        # sections swell slowly. Spectral motion without syllabic AM: the
        # boundary that separates dialogue from sung vocals / legato strings
        # / orchestral scoring. (Synthesis family deliberately differs from
        # models/eval_data.py's scale-quantized melodic generators.)
        n_voices = rng.randint(1, 4)
        for _ in range(n_voices):
            logf0 = np.log(rng.uniform(110, 520))
            steps = rng.randn(samples) * rng.uniform(0.5, 2.0) / np.sqrt(
                frame_rate
            )
            walk = np.cumsum(steps)
            # smooth the walk to glide-rate motion (centered ~0.3 s box
            # filter via cumsum — O(n), a convolve here is O(n·k))
            kw = max(int(0.15 * frame_rate), 1)
            cs = np.concatenate([[0.0], np.cumsum(walk)])
            idx = np.arange(samples)
            lo = np.maximum(idx - kw, 0)
            hi = np.minimum(idx + kw, samples - 1)
            walk = (cs[hi + 1] - cs[lo]) / (hi - lo + 1)
            walk = np.clip(walk, -0.7, 0.7)  # stay within ~1 octave
            vib_depth = rng.uniform(0.01, 0.06)  # ±0.17-1.0 semitone
            vib = vib_depth * np.sin(
                2 * np.pi * rng.uniform(4.0, 7.0) * t + rng.uniform(0, 6.28)
            )
            f0 = np.exp(logf0 + walk + vib)
            phase = 2 * np.pi * np.cumsum(f0) / frame_rate
            voice = np.zeros(samples, np.float32)
            rolloff = rng.uniform(0.7, 1.4)
            for h in range(1, rng.randint(5, 13)):
                voice += (
                    rng.uniform(0.5, 1.5) / h**rolloff
                ) * np.sin(h * phase + rng.uniform(0, 6.28)).astype(np.float32)
            if rng.rand() < 0.5:
                # sung-vocals texture: the SAME sustained melodic source
                # heard through a vocal tract — vowel resonances held for a
                # whole phrase (redrawn at phrase boundaries), breath gaps
                # between phrases, and still no syllabic AM. Spectrally it
                # is a voice (harmonics through formants), which is exactly
                # the cue a net trained only on unfiltered harmonic stacks
                # mistakes for speech. Differs from models/eval_data.py's
                # sung generator by design: random-walk pitch (no note
                # grid), independent Gaussian vowel draws per phrase.
                shaped = np.zeros(samples, np.float32)
                pos = 0
                while pos < samples:
                    seg_len = min(
                        int(rng.uniform(1.5, 4.5) * frame_rate),
                        samples - pos,
                    )
                    seg = voice[pos : pos + seg_len]
                    spec = np.fft.rfft(seg)
                    fr = np.fft.rfftfreq(seg_len, 1.0 / frame_rate)
                    gain = np.full_like(fr, 0.05)
                    for lo, hi in ((280, 900), (850, 2300), (2200, 3400)):
                        c = rng.uniform(lo, hi)
                        bw = rng.uniform(0.08, 0.2) * c
                        gain = gain + np.exp(-0.5 * ((fr - c) / bw) ** 2)
                    gain *= 1.0 / (
                        1.0 + (fr / rng.uniform(2500.0, 4000.0)) ** 1.7
                    )
                    seg = np.fft.irfft(spec * gain, seg_len).astype(
                        np.float32
                    )
                    fade = min(int(0.12 * frame_rate), seg_len // 2)
                    if fade > 0:
                        seg[:fade] *= np.linspace(
                            0.0, 1.0, fade, dtype=np.float32
                        )
                        seg[seg_len - fade :] *= np.linspace(
                            1.0, 0.0, fade, dtype=np.float32
                        )
                    shaped[pos : pos + seg_len] = seg
                    pos += seg_len + int(rng.uniform(0.1, 0.5) * frame_rate)
                peak = float(np.max(np.abs(shaped))) + 1e-9
                voice = shaped / peak * rng.uniform(1.5, 3.5)
            swell = (1.0 - rng.uniform(0.15, 0.4)) + rng.uniform(
                0.15, 0.4
            ) * np.sin(
                2 * np.pi * rng.uniform(0.05, 0.4) * t + rng.uniform(0, 6.28)
            )
            x += (10 ** rng.uniform(-1.5, -0.7)) * voice * swell.astype(
                np.float32
            )
        if rng.rand() < 0.4:  # sparse low damped hits (timpani-class)
            for _ in range(max(1, int(samples / frame_rate / 3.0))):
                pos = rng.randint(0, max(1, samples - frame_rate // 3))
                hl = min(int(0.35 * frame_rate), samples - pos)
                tt = np.arange(hl) / frame_rate
                x[pos : pos + hl] += (
                    (10 ** rng.uniform(-1.2, -0.6))
                    * np.sin(2 * np.pi * rng.uniform(55, 95) * tt)
                    * np.exp(-tt / 0.1)
                ).astype(np.float32)
    elif mode == 4:  # transient trains: claps/foley impacts, broadband decays
        level = 10 ** rng.uniform(-1.2, -0.3)
        density = rng.uniform(8, 35)  # impacts per second
        n_hits = max(1, int(samples / frame_rate * density))
        dlen = int(rng.uniform(0.004, 0.02) * frame_rate)
        env = np.exp(-np.arange(dlen) / max(1, int(0.0025 * frame_rate)))
        for pos in rng.randint(0, max(1, samples - dlen), size=n_hits):
            x[pos : pos + dlen] += (
                level * rng.uniform(0.2, 1.0) * env * rng.randn(dlen)
            )
    elif mode == 5:  # note onsets: struck/plucked decaying harmonics
        level = 10 ** rng.uniform(-1.5, -0.5)
        pos = 0
        while pos < samples - frame_rate // 10:
            nl = min(int(rng.uniform(0.12, 0.6) * frame_rate), samples - pos)
            f = rng.uniform(80, 900)
            tt = np.arange(nl) / frame_rate
            env = np.exp(-tt / rng.uniform(0.05, 0.35))
            note = sum(
                np.sin(2 * np.pi * f * h * tt + rng.uniform(0, 6.28)) / h
                for h in (1, 2, 3, 4)
            )
            x[pos : pos + nl] += (level * env * note).astype(np.float32)
            pos += nl
    elif mode == 6:  # crowd babble: many overlapped talkers -> texture
        # voices draw from every speech family (incl. source-filter), so the
        # negative tracks whatever cues the positive class carries
        voices = rng.randint(9, 17)
        # most draws homogenize voice loudness: a crowd mic hears talkers
        # at comparable levels, and the wide per-voice level spread from
        # synth_speech otherwise makes every babble draw a
        # few-dominant-voices mixture — a systematically easier texture
        # than a flat wall of talkers. The round-4 dominance probe showed
        # the shipped net's residual babble false fires concentrate where
        # NO voice dominates (fire rate 0.30 below −6 dB dominance), i.e.
        # exactly on the flat-wall texture, so the flat share and the
        # minimum crowd size were both raised (0.5 → 0.85, 6 → 9 voices)
        # and the per-voice spread tightened toward a crowd mic's.
        equal_levels = rng.rand() < 0.85
        for _ in range(voices):
            v, _active = synth_speech(rng, samples, frame_rate)
            if equal_levels:
                v = v / (float(np.max(np.abs(v))) + 1e-9) * rng.uniform(
                    0.4, 0.8
                )
            x += np.roll(v, rng.randint(samples)).astype(np.float32)
        x *= rng.uniform(1.8, 3.2) / voices
    else:  # laughter-class: overlapping regular voiced burst trains,
        # hard-gated at syllable rate with pitch declination — rhythmic and
        # harmonic like speech, but periodic rather than phrase-structured
        for _ in range(rng.randint(2, 6)):
            rate = rng.uniform(3.5, 6.5)
            duty = rng.uniform(0.35, 0.6)
            gatephase = 2 * np.pi * rate * t + rng.uniform(0, 6.28)
            gate = (np.cos(gatephase) > np.cos(np.pi * duty)).astype(np.float32)
            f0 = rng.uniform(170, 420) * np.exp(-t / rng.uniform(2.5, 9.0))
            voiced = np.sin(2 * np.pi * np.cumsum(f0) / frame_rate)
            breath = rng.uniform(0.3, 0.8) * rng.randn(samples)
            x += (
                (voiced + breath) * gate * (10 ** rng.uniform(-1.6, -0.7))
            ).astype(np.float32)
    return x


def synth_batch(
    rng: np.random.RandomState,
    n_clips: int,
    clip_seconds: float,
    frame_rate: int,
    sample_rate: int,
    return_weights: bool = False,
) -> Tuple[np.ndarray, ...]:
    """(pcm int16 [n, samples], window labels float [n, windows]).

    With ``return_weights``, also returns per-clip loss weights [n]: the
    voiced adversarial negatives (babble, laughter) are up-weighted — a
    detector that over-recalls noisy speech pays for it there, and those
    classes are a small slice of the clip stream even after oversampling.
    """
    window = frame_rate // sample_rate
    samples = int(clip_seconds * frame_rate)
    n_windows = samples // window
    pcm = np.zeros((n_clips, samples), np.float32)
    labels = np.zeros((n_clips, n_windows), np.float32)
    weights = np.ones(n_clips, np.float32)
    for i in range(n_clips):
        noise_level = 10 ** rng.uniform(-3.5, -1.5)
        x = rng.randn(samples).astype(np.float32) * noise_level
        if rng.rand() < 0.5:
            speech, active = synth_speech(rng, samples, frame_rate)
            if rng.rand() < 0.3:  # roomy dialogue
                speech = _reverb(rng, speech, frame_rate)
            speech_power = float(
                np.mean(speech[active > 0.5] ** 2) + 1e-12
            )
            if rng.rand() < 0.5:  # dialogue over a background bed, mixed at
                # a controlled speech-to-bed ratio down to 0 dB. Beds are
                # drawn to sharpen the two boundaries the hard negatives
                # probe: crowd babble under a dominant voice (cocktail-party
                # foreground speech — "coherent voice over babble = speech",
                # "babble alone = not"), and onset-heavy music under speech
                u = rng.rand()
                if u < 0.35:
                    bed_mode = 6  # crowd babble bed
                    smr_db = rng.uniform(3.0, 12.0)
                elif u < 0.55:
                    bed_mode = 5  # note-onset music bed
                    smr_db = rng.uniform(0.0, 12.0)
                elif u < 0.75:
                    bed_mode = 3  # moving-spectrum music bed (scoring)
                    smr_db = rng.uniform(0.0, 12.0)
                else:
                    bed_mode = rng.randint(3)  # benign tones/chords
                    smr_db = rng.uniform(0.0, 14.0)
                bed = synth_nonspeech(rng, samples, frame_rate, mode=bed_mode)
                bed_power = float(np.mean(bed**2) + 1e-12)
                x += bed * np.sqrt(
                    speech_power / (10 ** (smr_db / 10.0)) / bed_power
                )
            interlude = rng.rand() < 0.4
            if interlude:
                # interlude beds: voiced non-speech filling the PAUSES
                # between utterances (movie laughter/babble/music breaks).
                # A wide receptive field otherwise learns "speech nearby →
                # speech" and bleeds onto adjacent beds — exactly the
                # end-to-end failure the *_breaks agreement scenarios probe.
                bed_mode = int(rng.choice((3, 5, 6, 7)))
                bed = synth_nonspeech(rng, samples, frame_rate, mode=bed_mode)
                bed_power = float(np.mean(bed**2) + 1e-12)
                smr_db = rng.uniform(0.0, 9.0)
                x += (
                    bed
                    * (active < 0.5)
                    * np.sqrt(speech_power / (10 ** (smr_db / 10.0)) / bed_power)
                )
            if rng.rand() < 0.75:  # noisy scene: colored noise with a random
                # spectral slope f^-α (α 0 = white … 1.2 = red-ish), at an
                # SNR that reaches genuinely hard — half the draws come from
                # an explicit hard band so low-SNR recall gets real gradient
                noise = rng.randn(samples).astype(np.float32)
                alpha = rng.uniform(0.0, 1.2)
                if alpha > 0.05:
                    spec = np.fft.rfft(noise)
                    freqs = np.fft.rfftfreq(samples, 1.0 / frame_rate)
                    spec *= 1.0 / np.maximum(freqs, 20.0) ** alpha
                    noise = np.fft.irfft(spec, samples).astype(np.float32)
                noise_power = float(np.mean(noise**2) + 1e-12)
                snr_db = (
                    rng.uniform(-2.0, 8.0) if rng.rand() < 0.5
                    else rng.uniform(0.0, 22.0)
                )
                x += noise * np.sqrt(
                    speech_power / (10 ** (snr_db / 10.0)) / noise_power
                )
                if snr_db < 5.0:
                    # hard-SNR recall needs explicit gradient share: adding
                    # the moving-music negative class diluted it enough to
                    # cost measured low-SNR accuracy (1.000 -> 0.976) until
                    # these clips were re-weighted
                    weights[i] = max(weights[i], 1.75)
            x += speech
            win_act = active[: n_windows * window].reshape(n_windows, window)
            labels[i] = (win_act.mean(axis=1) > 0.5).astype(np.float32)
            if interlude:  # speech/bed boundaries are the hard gradient
                weights[i] = 2.0
        else:
            mode = _negative_mode(rng)
            x += synth_nonspeech(rng, samples, frame_rate, mode=mode)
            if mode in (6, 7):  # babble / laughter: the hard negatives
                weights[i] = 2.5
            elif mode == 3:  # moving-spectrum music: voiced, gliding, no AM
                weights[i] = 2.0
            elif mode == 5:  # note onsets: syllable-rate energy structure
                weights[i] = 1.5
        pcm[i] = x
    pcm16 = np.clip(pcm * 32767, -32768, 32767).astype(np.int16)
    # Wire-codec augmentation: inference ALWAYS sees the host->device wire
    # compander (8-bit µ-law by default, packed 6-bit under
    # FFS_TPU_WIRE=mulaw6 — ops/features.prepare_staged_input), but clean
    # training audio never did. Round-tripping a share of clips through
    # each codec closes the train/infer gap; measured without it, the
    # 6-bit wire's ~26 dB quantization floor cost silero 0.10 of window
    # accuracy on plucked_music (0.989 -> 0.889) while the 8-bit wire's
    # ~38 dB floor was absorbed silently.
    for i in range(n_clips):
        u = rng.rand()
        if u < 0.30:
            pcm16[i] = _wire_roundtrip(pcm16[i], 127.0)
        elif u < 0.55:
            pcm16[i] = _wire_roundtrip(pcm16[i], 31.0)
    if return_weights:
        return pcm16, labels, weights
    return pcm16, labels


def _wire_roundtrip(pcm_i16: np.ndarray, levels: float) -> np.ndarray:
    """µ-law compander round-trip at ``levels`` per sign (127 = the 8-bit
    wire, 31 = the packed 6-bit wire), matching the device decode arithmetic
    in ops/pallas/frontend (mulaw_decode / unpack_mulaw6) exactly."""
    x = pcm_i16.astype(np.float32) / 32768.0
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log1p(255.0)
    c = np.round(y * levels)
    mag = np.abs(c) * (1.0 / levels)
    dec = np.sign(c) * (32768.0 / 255.0) * (np.exp2(mag * 8.0) - 1.0)
    return np.clip(dec, -32768, 32767).astype(np.int16)


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
