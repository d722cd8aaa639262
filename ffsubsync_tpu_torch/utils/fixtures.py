# -*- coding: utf-8 -*-
"""Synthetic-fixture writers shared by benchmarks, eval harnesses and tests.

One int16 WAV writer and one SRT span writer, so a header fix or format
tweak lands everywhere at once (bench.py, scripts/eval_vad_agreement.py and
tests/helpers.py previously each carried their own copy).
"""
import struct

import numpy as np


def write_wav_i16(path: str, pcm_or_wave, frame_rate: int, channels: int = 1) -> None:
    """Minimal PCM16 WAV writer.

    Accepts int16 PCM directly or float waveforms in [-1, 1] (scaled and
    clipped). Multi-channel input may be [n] (replicated) or [n, channels].
    """
    arr = np.asarray(pcm_or_wave)
    if arr.dtype != np.int16:
        arr = np.clip(arr * 32767, -32768, 32767).astype(np.int16)
    if channels > 1 and arr.ndim == 1:
        arr = np.repeat(arr[:, None], channels, axis=1)
    data = arr.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, 1, channels, frame_rate,
                frame_rate * channels * 2, channels * 2, 16,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def format_srt_timestamp(t: float) -> str:
    """Seconds → ``HH:MM:SS,mmm``."""
    ms = int(round(t * 1000))
    return "%02d:%02d:%02d,%03d" % (
        ms // 3600000, ms % 3600000 // 60000, ms % 60000 // 1000, ms % 1000
    )


def write_srt_spans(path: str, spans, text: str = "line %d") -> None:
    """Write one simple cue per (start_s, end_s) span; negative starts are
    dropped (cues shifted before the timeline origin)."""
    with open(path, "w") as f:
        for i, (a, b) in enumerate(s for s in spans if s[0] >= 0):
            f.write(
                "%d\n%s --> %s\n%s\n\n"
                % (
                    i + 1,
                    format_srt_timestamp(a),
                    format_srt_timestamp(b),
                    text % (i + 1) if "%d" in text else text,
                )
            )
