#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Benchmark every declared BASELINE.json configuration that ``bench`` and
``bench_batch`` do not already cover, through the CLI entry point
(``sync.run(make_parser().parse_args(argv))``):

  srt_srt        srt<->srt sync of a 45-min cue list
  wav5_energy    5-min WAV reference + the auditok-class energy VAD
  multiseg       --multi-segment-sync: 8 sampled segments across a 2-h WAV

Counterpart of the JAX package's ``scripts/bench_suite.py``, with its
knobs and JSON line. srt_srt stays on the host, as the reference's does: a
subtitle reference has no audio, and ``ops/align._align_candidates_host``
scores it in numpy. That is the reference's routing, not a fallback.

Each case reports best/median/worst wall seconds over BENCH_RUNS runs
(default 3) plus the recovered-offset error. Prints ONE JSON line with
every case, ``platform`` (the torch device type) and ``device`` (the
card's ``nvidia-smi`` name and power limit, null on the CPU); stderr ends
with ``frontend kernel launches: N``.

Usage: python -m ffsubsync_tpu_torch.scripts.bench_suite
Env knobs: BENCH_RUNS (3), BENCH_PLATFORM (``cuda`` by default, or
``cpu``).

Reference envelope being compared against: "usually finishes in 20 to 30
seconds" per movie, srt<->srt "typically runs in less than a second"
(reference README.md:209-214).
"""
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ffsubsync_tpu_torch.scripts.bench import (
    card_line, log, log_launches, runs_knob, select_device,
)

TRUE_OFFSET = 4.27  # seconds the subtitles fire early
FRAME_RATE = 12000  # native-read window-compatible analysis rate


def _spans(rng, duration, lo=1.0, hi=4.0, gap_lo=0.8, gap_hi=4.0, t0=2.0):
    spans = []
    t = t0
    while t < duration - 6.0:
        length = rng.uniform(lo, hi)
        spans.append((t, t + length))
        t += length + rng.uniform(gap_lo, gap_hi)
    return spans


def _timed_runs(n_runs, fn):
    times = []
    err_ms = None
    for i in range(n_runs):
        t0 = time.perf_counter()
        result = fn()
        times.append(time.perf_counter() - t0)
        if result.get("offset_seconds") is not None:
            err_ms = result["err_ms"]
        log("  run %d: %.3f s (err %s ms)" % (i, times[-1], err_ms))
    times.sort()
    return {
        "best_s": round(times[0], 3),
        "median_s": round(times[len(times) // 2], 3),
        "worst_s": round(times[-1], 3),
        "offset_err_ms": None if err_ms is None else round(err_ms, 1),
    }


def cli_case(argv):
    """One sync through the CLI entry; its result dict, with ``err_ms``
    against ``TRUE_OFFSET`` when it found an offset."""
    from ffsubsync_tpu_torch.cli import make_parser
    from ffsubsync_tpu_torch.sync import run as sync_run

    result = sync_run(make_parser().parse_args(argv))
    if result.get("offset_seconds") is not None:
        result["err_ms"] = abs(result["offset_seconds"] - TRUE_OFFSET) * 1000.0
    return result


def _shifted_srt(path, spans):
    from ffsubsync_tpu_torch.utils.fixtures import write_srt_spans

    write_srt_spans(path, [(a - TRUE_OFFSET, b - TRUE_OFFSET) for a, b in spans])


def _speech_wav(path, rng, duration):
    """A speech-like int16 WAV of ``duration`` seconds at ``FRAME_RATE``;
    returns its spans."""
    from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

    spans = _spans(rng, duration)
    pcm = np.clip(
        speech_signal_for_spans(duration, spans, FRAME_RATE, speech_level=0.35)
        * 32767,
        -32768,
        32767,
    ).astype(np.int16)
    write_wav_i16(path, pcm, FRAME_RATE)
    return spans


def srt_srt(rng, tmpdir, n_runs, minutes=45.0):
    """srt<->srt: a cue list of ``minutes`` and its shifted copy, aligned
    on the host. Returns (the case's timings, the CLI argv)."""
    from ffsubsync_tpu_torch.utils.fixtures import write_srt_spans

    ref_srt = os.path.join(tmpdir, "ref.srt")
    in_srt = os.path.join(tmpdir, "in.srt")
    spans = _spans(rng, minutes * 60.0)
    write_srt_spans(ref_srt, spans)
    _shifted_srt(in_srt, spans)
    argv = [ref_srt, "-i", in_srt, "-o", os.path.join(tmpdir, "out.srt")]
    log("srt_srt (%g-min cue list)..." % minutes)
    return _timed_runs(n_runs, lambda: cli_case(argv)), argv


def wav5_energy(rng, tmpdir, n_runs, minutes=5.0):
    """A WAV of ``minutes`` with ``--vad auditok`` (one frontend launch
    over the whole signal). Returns (the case's timings, the CLI argv)."""
    wav = os.path.join(tmpdir, "five.wav")
    srt = os.path.join(tmpdir, "five.srt")
    _shifted_srt(srt, _speech_wav(wav, rng, minutes * 60.0))
    argv = [wav, "-i", srt, "-o", os.path.join(tmpdir, "out.srt"), "--vad", "auditok"]
    log("wav5_energy (%g-min WAV, auditok-class energy VAD)..." % minutes)
    return _timed_runs(n_runs, lambda: cli_case(argv)), argv


def multiseg(rng, tmpdir, n_runs, minutes=120.0, segments=8):
    """``--multi-segment-sync`` with ``segments`` windows of 60 s across a
    WAV of ``minutes`` (the default VAD, one frontend launch per segment).
    Returns (the case's timings, the CLI argv)."""
    wav = os.path.join(tmpdir, "movie2h.wav")
    srt = os.path.join(tmpdir, "movie2h.srt")
    _shifted_srt(srt, _speech_wav(wav, rng, minutes * 60.0))
    argv = [wav, "-i", srt, "-o", os.path.join(tmpdir, "out.srt"),
            "--multi-segment-sync", "--segment-count", str(segments)]
    log("multiseg (%d segments across %g-min WAV)..." % (segments, minutes))
    return _timed_runs(n_runs, lambda: cli_case(argv)), argv


def main(srt_minutes=45.0, wav_minutes=5.0, multiseg_minutes=120.0, segments=8) -> int:
    """The three cases at the reference's sizes (the arguments exist for
    tests), in its order, from one ``RandomState(0)``."""
    device = select_device()
    card = card_line(device)
    n_runs = runs_knob("BENCH_RUNS", "3")
    report = {}
    tmpdir = tempfile.mkdtemp(prefix="ffs_suite_")
    try:
        rng = np.random.RandomState(0)
        report["srt_srt"] = srt_srt(rng, tmpdir, n_runs, srt_minutes)[0]
        report["wav5_energy"] = wav5_energy(rng, tmpdir, n_runs, wav_minutes)[0]
        report["multiseg"] = multiseg(rng, tmpdir, n_runs, multiseg_minutes, segments)[0]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    log_launches()
    print(
        json.dumps(
            {
                "metric": "config_suite_wall_seconds",
                "unit": "s",
                "timing": "best-of-%d" % n_runs,
                "platform": device.type,
                "device": card,
                **report,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
