#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Headline benchmark: 90-minute end-to-end sync throughput on one card.

Counterpart of the JAX package's root ``bench.py``, with its knobs, its
timing semantics and its JSON line. It times the device path of one
90-minute movie sync: the chunked VAD over the decoded PCM (the frontend
kernel and the VAD program per pipeline chunk) plus the complete
candidate-ratio FFT search, and reports syncs/sec/chip. ``vs_baseline``
compares against the reference ffsubsync's published figure for the same
task: "usually finishes in 20 to 30 seconds" on CPU (reference
README.md:209-212; midpoint 25 s).

Usage: python -m ffsubsync_tpu_torch.scripts.bench

Prints ONE JSON line on stdout (the reference's keys, ``platform`` the
torch device type, and ``device``: the card's ``nvidia-smi`` name and
power limit, null on the CPU); diagnostics go to stderr, the last of them
``frontend kernel launches: N`` over the whole run.

Env knobs: BENCH_MINUTES (90), BENCH_VAD (fused), BENCH_FRAME_RATE (the
analysis rate of a 48 kHz decode), BENCH_RUNS (5), BENCH_MAX_RUNS (15),
BENCH_TARGET_S (1.8), BENCH_VAD_RUNS (3), BENCH_E2E (1), and
BENCH_PLATFORM: unset or ``cuda`` runs on the card and raises without one;
``cpu`` runs the port's plain PyTorch path on the CPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

TRUE_OFFSET = 7.34  # seconds the subtitles fire early
PLATFORMS = ("cuda", "cpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def select_device():
    """The device ``BENCH_PLATFORM`` names (unset: ``cuda``), through the
    port's device rule (``FFS_TORCH_DEVICE``): no card raises, and any
    name but ``cuda`` or ``cpu`` raises."""
    platform = os.environ.get("BENCH_PLATFORM") or "cuda"
    if platform not in PLATFORMS:
        raise ValueError(
            "BENCH_PLATFORM=%r: choose one of %s" % (platform, ", ".join(PLATFORMS))
        )
    os.environ["FFS_TORCH_DEVICE"] = platform
    from ffsubsync_tpu_torch.device import get_device

    return get_device()


def card_line(device):
    """``nvidia-smi``'s name and power limit of ``device``'s card, or None
    on the CPU."""
    if device.type != "cuda":
        return None
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--id=%d" % index, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def runs_knob(name, default):
    """An integer run-count knob; fewer than one run leaves nothing to
    report, so it raises."""
    n = int(os.environ.get(name, default))
    if n < 1:
        raise ValueError("%s=%d: at least one run is needed" % (name, n))
    return n


def log_launches():
    from ffsubsync_tpu_torch.ops.frontend import fused_frontend

    log("frontend kernel launches: %d" % fused_frontend.launches)


def make_problem(minutes, frame_rate):
    """The untimed synthetic problem: ``minutes`` of speech-like PCM at
    ``frame_rate`` (spans of 1-4 s, gaps of 0.8-4 s, ``RandomState(0)``)
    and the subtitle candidates of those spans shifted ``TRUE_OFFSET``
    early, one per framerate ratio. Returns (pcm, spans, sub_spans,
    candidates, ratios)."""
    from ffsubsync_tpu_torch.constants import FRAMERATE_RATIOS, SAMPLE_RATE
    from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu_torch.subs.raster import RasterSpec

    duration = minutes * 60.0
    rng = np.random.RandomState(0)
    spans = []
    t = 2.0
    while t < duration - 6.0:
        length = rng.uniform(1.0, 4.0)
        spans.append((t, t + length))
        t += length + rng.uniform(0.8, 4.0)
    wav = speech_signal_for_spans(duration, spans, frame_rate, speech_level=0.35)
    pcm = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
    del wav

    # subtitle cue geometry: spans on the subtitle timeline (shifted early)
    candidates = []
    ratios = [1.0] + FRAMERATE_RATIOS + [1.0 / r for r in FRAMERATE_RATIOS]
    sub_spans = [(a - TRUE_OFFSET, b - TRUE_OFFSET) for a, b in spans]
    n_sub = int((max(b for _, b in sub_spans)) * SAMPLE_RATE) + 2
    for ratio in ratios:
        starts = np.array(
            [int(round(a * ratio * SAMPLE_RATE)) for a, _ in sub_spans], np.int32
        )
        ends = np.array(
            [int(round(b * ratio * SAMPLE_RATE)) for _, b in sub_spans], np.int32
        )
        n = int(n_sub * ratio) + 2
        keep = starts >= 0
        candidates.append(
            RasterSpec(
                n_samples=n,
                starts=np.clip(starts[keep], 0, n),
                ends=np.clip(ends[keep], 0, n),
                weight=min(1.0 / ratio, 1.0),
                max_time=n / SAMPLE_RATE,
                sample_rate=SAMPLE_RATE,
            )
        )
    return pcm, spans, sub_spans, candidates, ratios


def _sync(signal):
    """Wait for the card's work on ``signal``'s labels (attributed runs
    only); CPU work is done when it returns."""
    import torch

    if signal.device is not None and signal.device.type == "cuda":
        torch.cuda.synchronize(signal.device)


def main() -> int:
    device = select_device()
    card = card_line(device)

    from ffsubsync_tpu_torch.constants import SAMPLE_RATE
    from ffsubsync_tpu_torch.ops.align import align_candidates
    from ffsubsync_tpu_torch.ops.features import analysis_rate
    from ffsubsync_tpu_torch.ops.vad import make_detector

    minutes = float(os.environ.get("BENCH_MINUTES", "90"))
    vad_name = os.environ.get("BENCH_VAD", "fused")
    # production decodes straight to the analysis rate
    # (media/audio.VideoSpeechSource._decode_rate); the synthetic PCM starts
    # from what the decoder would deliver under the default flags
    frame_rate = int(os.environ.get(
        "BENCH_FRAME_RATE", analysis_rate(48000, SAMPLE_RATE)
    ))
    n_min = runs_knob("BENCH_RUNS", "5")
    n_max = int(os.environ.get("BENCH_MAX_RUNS", "15"))
    target_s = float(os.environ.get("BENCH_TARGET_S", "1.8"))
    n_vad = runs_knob("BENCH_VAD_RUNS", "3")
    log("device:", device, card or "")

    # --- fabricate the problem (untimed) ----------------------------------
    log("synthesizing %.0f min of audio..." % minutes)
    pcm, spans, sub_spans, candidates, ratios = make_problem(minutes, frame_rate)
    log("%d speech spans, %d samples" % (len(spans), len(pcm)))

    def run_once(attribute: bool = False):
        # the buffered product path (media/audio.py): chunk dispatch, labels
        # stay on the device (LazySpeechSignal), the batched candidate
        # search reads them there; only scores and offsets come back.
        # With ``attribute`` (warm-up and diagnostic runs only) the VAD
        # drain is synchronized for a per-stage breakdown:
        #   stage_s = host staging (decimate/mu-law/frame), the host-to-device
        #             copies and the enqueue
        #   vad_s   = the card's VAD work still queued when staging ends
        #   align_s = batched candidate search incl. the score/offset pull
        # TIMED runs add no synchronize: their window closes when
        # align_candidates returns, which is after its ``.cpu().tolist()``
        # pull of the scores and offsets (ops/align.py), so it cannot close
        # before the card's work ends.
        t0 = time.perf_counter()
        detector = make_detector(vad_name, SAMPLE_RATE, frame_rate, 0.0, device)
        signal = detector.gather([detector.dispatch_async(pcm)])
        breakdown = None
        t2 = t1 = time.perf_counter()
        if attribute:
            _sync(signal)
            t2 = time.perf_counter()
        results = align_candidates(
            signal, candidates, max_offset_samples=60 * SAMPLE_RATE
        )
        t3 = time.perf_counter()
        if attribute:
            breakdown = {
                "stage_s": round(t1 - t0, 3),
                "vad_s": round(t2 - t1, 3),
                "align_s": round(t3 - t2, 3),
                "n_launches": len(signal._parts),
            }
            log(
                "  stage %.3f s | vad drain %.3f s | align %.3f s (%d launches)"
                % (t1 - t0, t2 - t1, t3 - t2, len(signal._parts))
            )
        return signal, results, breakdown

    # --- warm-up (kernel build, cuFFT plans) --------------------------------
    log("warmup (build)...")
    t0 = time.perf_counter()
    signal, results, _ = run_once(attribute=True)
    log("warmup took %.2f s" % (time.perf_counter() - t0))

    # --- timed runs ----------------------------------------------------------
    # best/median/worst; the HEADLINE is the median. Adaptive sampling: after
    # the minimum run count, keep sampling while the median is still above
    # BENCH_TARGET_S
    run_times = []
    i = 0

    def _median(xs):
        return sorted(xs)[len(xs) // 2]

    while i < n_min or (i < n_max and _median(run_times) > target_s):
        t0 = time.perf_counter()
        signal, results, _ = run_once()
        run_s = time.perf_counter() - t0
        log("run %d: %.3f s" % (i, run_s))
        run_times.append(run_s)
        i += 1
    n_runs = len(run_times)
    run_times.sort()
    best_s = run_times[0]
    median_s = run_times[len(run_times) // 2]
    worst_s = run_times[-1]
    elapsed = median_s  # headline

    # one attributed diagnostic run AFTER the timed loop: its extra
    # synchronize stays out of the timed distribution, and warm caches keep
    # the build out of vad_s/align_s
    log("attributed diagnostic run...")
    _, _, diag_breakdown = run_once(attribute=True)

    # --- VAD-only throughput (VAD audio-hours/sec) --------------------------
    vad_times = []
    for _ in range(n_vad):
        t0 = time.perf_counter()
        det = make_detector(vad_name, SAMPLE_RATE, frame_rate, 0.0, device)
        _sync(det.gather([det.dispatch_async(pcm)]))
        vad_times.append(time.perf_counter() - t0)
    vad_times.sort()
    vad_median = vad_times[len(vad_times) // 2]
    vad_hours_per_sec = (minutes / 60.0) / vad_median
    log(
        "vad-only: best %.3f s / median %.3f s -> %.1f audio-hours/sec"
        % (vad_times[0], vad_median, vad_hours_per_sec)
    )

    best = max(range(len(results)), key=lambda i: results[i].score)
    got_offset = results[best].offset / SAMPLE_RATE
    offset_err_ms = abs(got_offset - TRUE_OFFSET) * 1000.0
    log(
        "sync best %.3f s / median %.3f s / worst %.3f s | best ratio %.5f | "
        "offset %.2f s (err %.1f ms) | VAD speech frac %.3f"
        % (
            best_s, median_s, worst_s, ratios[best], got_offset,
            offset_err_ms, (np.asarray(signal) > 0.5).mean(),
        )
    )
    if offset_err_ms > 100:
        log("WARNING: offset error above 100 ms — benchmark result suspect")

    # --- end-to-end CLI case (through run(): WAV read → VAD → align → write)
    e2e_s = None
    e2e_offset_err_ms = None
    if os.environ.get("BENCH_E2E", "1") == "1":
        e2e_s, e2e_offset_err_ms = _bench_cli_end_to_end(
            pcm, frame_rate, sub_spans, vad_name
        )

    syncs_per_sec = 1.0 / elapsed
    baseline_seconds = 25.0  # reference README: 20-30 s per movie on CPU
    vs_baseline = baseline_seconds / elapsed
    log_launches()
    print(
        json.dumps(
            {
                "metric": "90min_movie_syncs_per_sec_per_chip",
                "value": round(syncs_per_sec, 4),
                "unit": "syncs/sec/chip",
                "vs_baseline": round(vs_baseline, 2),
                "timing": "median-of-%d" % n_runs,
                "best_s": round(best_s, 3),
                "median_s": round(median_s, 3),
                "worst_s": round(worst_s, 3),
                "offset_err_ms": round(offset_err_ms, 1),
                "vad_audio_hours_per_sec": round(vad_hours_per_sec, 2),
                "vad_median_s": round(vad_median, 3),
                "breakdown": diag_breakdown,
                "e2e_cli_s": None if e2e_s is None else round(e2e_s, 3),
                "e2e_offset_err_ms": (
                    None
                    if e2e_offset_err_ms is None
                    else round(e2e_offset_err_ms, 1)
                ),
                "platform": device.type,
                "device": card,
            }
        )
    )
    return 0


def _bench_cli_end_to_end(pcm, frame_rate, sub_spans, vad_name):
    """Time one sync through the real entry point: run() with a WAV
    reference read by the native WAV reader. Returns (seconds, offset err)."""
    import shutil
    import tempfile

    from ffsubsync_tpu_torch.cli import make_parser
    from ffsubsync_tpu_torch.sync import run as sync_run
    from ffsubsync_tpu_torch.utils.fixtures import write_srt_spans, write_wav_i16

    tmpdir = tempfile.mkdtemp(prefix="ffs_bench_")
    try:
        wav_path = os.path.join(tmpdir, "movie.wav")
        srt_path = os.path.join(tmpdir, "movie.srt")
        out_path = os.path.join(tmpdir, "synced.srt")
        t0 = time.perf_counter()
        write_wav_i16(wav_path, pcm, frame_rate)
        log("wrote bench WAV in %.2f s" % (time.perf_counter() - t0))
        write_srt_spans(srt_path, sub_spans)
        e2e_s = None
        err_ms = None
        for attempt in range(2):  # the first run may build WAV-path buckets
            args = make_parser().parse_args(
                [wav_path, "-i", srt_path, "-o", out_path, "--vad", vad_name]
            )
            t0 = time.perf_counter()
            result = sync_run(args)
            e2e_s = time.perf_counter() - t0
            if result.get("offset_seconds") is None:  # failed sync: run()
                # reports retval!=0 / None offset rather than raising
                log("e2e cli run %d: %.3f s (SYNC FAILED)" % (attempt, e2e_s))
                err_ms = None
                continue
            err_ms = abs(result["offset_seconds"] - TRUE_OFFSET) * 1000.0
            log(
                "e2e cli run %d: %.3f s (offset err %.1f ms)"
                % (attempt, e2e_s, err_ms)
            )
        return e2e_s, err_ms
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
