#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch/CUDA port (ffsubsync_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the smoke check below
    python3 chip_smoke.py --measure    # the PERF.md measurements instead

Run from the repository root on a machine with a CUDA card and nvcc. It
needs no network and no jax. Phases, each fatal on failure:

1. probe the card (name, capability, power limit);
2. build the CUDA kernels from ``ffsubsync_tpu_torch/csrc`` (timed);
3. hold the frontend kernel against its plain PyTorch version on the card:
   every rate tier with trained weights plus the legacy 48 kHz window,
   every wire, a ragged window count, random and synthetic-speech PCM;
   then at the main path's own shape, the first 45-minute pipeline chunk
   of the synthetic 90-minute WAV as the port stages it, checked and timed;
4. the main path at full size: that synthetic 90-minute 12 kHz WAV synced
   to a shifted .srt through the port's CLI entry, with ``--vad fused`` and
   with the default VAD; the shift must be recovered within 0.15 s, the
   kernel must have run once per dispatched chunk, and the labels must
   reach the aligner as CUDA tensors;
5. fused labels of 10 minutes of that audio, card against CPU.

The last two lines of standard output are one JSON object describing the
kernels and one JSON object ``{"ok": true, "device": {...}}``.

``--measure`` runs phases 1 and 2, synthesizes the same WAV, and then
prints what PERF.md cites: the wall seconds of repeated 90-minute syncs
(fused and default VAD), a per-layer breakdown of one warm sync of each,
the device milliseconds of one ``_vad_program`` per mode on a 45-minute
chunk, and a ``torch.profiler`` table of one warm fused sync.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

TRUE_OFFSET_S = 7.34  # the subtitles fire this many seconds early
MINUTES = 90
RATE = 12000  # the analysis tier a 48 kHz decode is decimated to
SAMPLE_RATE = 100
CHUNK_SECONDS = 2700  # the port's default pipeline chunk (45 min)
LABEL_MINUTES = 10
# reference tolerances (tests/test_pallas_frontend.py): (rtol, atol)
TOLS = {"logmel": (2e-3, 2e-3), "bands": (2e-3, 1e-5), "total": (1e-4, 0.0)}


def log(*parts):
    print(*parts, flush=True)


def fail(msg):
    log("FAIL:", msg)
    sys.exit(1)


def probe():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False (torch %s)" % torch.__version__)
    cap = torch.cuda.get_device_capability(0)
    log("device:", torch.cuda.get_device_name(0), "capability", cap,
        "count", torch.cuda.device_count())
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])
    if cap != (9, 0):
        fail("expected a Hopper card (capability (9, 0)), got %r" % (cap,))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    return smi


def build():
    from ffsubsync_tpu_torch.ops import _build

    result = _build.build_library()
    log("build: %.2f s -> %s" % (result.seconds, os.path.relpath(result.path)))
    for line in result.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log("  ptxas:", line.strip())
    _build.load_library()


def compare(got, want, what):
    """Kernel outputs against plain ones under ``TOLS``; fails on any value
    out of tolerance. Returns the max abs error of each output."""
    import torch

    errs = {}
    for (name, (rtol, atol)), a, b in zip(TOLS.items(), got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail("%s, %s: bad shape or non-finite" % (what, name))
        err = (a - b).abs()
        bad = int((err > atol + rtol * b.abs()).sum())
        errs[name] = float(err.max())
        if bad:
            fail("%s, %s: %d values out of tolerance (max abs err %.3g)"
                 % (what, name, bad, errs[name]))
    log("  %s max|kernel-plain|: %s"
        % (what, ", ".join("%s %.3g" % kv for kv in errs.items())))
    return errs


def kernel_vs_plain(dev):
    """Phase 3, agreement on every tier and wire at a ragged window count.
    Returns the worst abs error of each output."""
    import numpy as np
    import torch

    from ffsubsync_tpu import native
    from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu_torch.ops import frontend as fe

    rng = np.random.RandomState(0)
    worst = {k: 0.0 for k in TOLS}
    n_windows = 1037  # ragged: no multiple of any tile
    for rate in (8000, 12000, 16000, 24000, 48000):
        window = rate // SAMPLE_RATE
        n = n_windows * window
        spans = [(0.5, 3.0), (4.0, 7.5), (8.5, 10.0)]
        speech = speech_signal_for_spans(n / rate + 0.01, spans, rate, speech_level=0.35)
        pcms = {
            "random": (rng.randn(n) * 3000).clip(-32768, 32767).astype(np.int16),
            "speech": np.clip(speech[:n] * 32767, -32768, 32767).astype(np.int16),
        }
        for kind, pcm in pcms.items():
            wires = {
                "i16": pcm.reshape(n_windows, window),
                "mulaw": fe.mulaw_encode_host(pcm).reshape(n_windows, window),
            }
            if window % 4 == 0:
                wires["mulaw6"] = native.stage_for_device_p6(pcm, 0, window, n_windows)
            for wire, framed in wires.items():
                x = torch.from_numpy(np.ascontiguousarray(framed)).to(dev)
                got = fe.fused_frontend(x, window, rate)
                torch.cuda.synchronize()
                errs = compare(got, fe.frontend_plain(x, window, rate),
                               "%5d Hz %-6s %-6s" % (rate, kind, wire))
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
    log("kernel vs plain: all tiers and wires within tolerance; worst "
        + ", ".join("%s %.3g" % kv for kv in worst.items()))
    return worst


def median_ms(fn, n=15, warm=3):
    """Median device milliseconds of ``fn()`` between two CUDA events."""
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    samples = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


def chunk_check_and_time(dev, pcm):
    """Phase 3 at the main path's shape: the first 45-minute chunk of the
    synthetic speech, staged as the port stages it (12 kHz, default mu-law
    wire), through kernel and plain version. Checks the two agree, then
    times both. Returns (abs errors, kernel ms, plain ms)."""
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    framed, rate, window, n_windows = prepare_staged_input(
        pcm[: CHUNK_SECONDS * RATE], RATE, SAMPLE_RATE
    )
    x = torch.from_numpy(framed).to(dev)
    shape = "[%d, %d] %s" % (x.shape[0], x.shape[1], str(x.dtype).replace("torch.", ""))
    if (rate, window, n_windows) != (RATE, RATE // SAMPLE_RATE, CHUNK_SECONDS * SAMPLE_RATE):
        fail("45-min chunk staged as %s at %d Hz, %d windows" % (shape, rate, n_windows))
    got = fe.fused_frontend(x, window, rate)
    torch.cuda.synchronize()
    errs = compare(got, fe.frontend_plain(x, window, rate),
                   "45-min speech chunk %s" % shape)
    del got
    times = {"fused_frontend": [], "frontend_plain": []}
    for fn in (fe.fused_frontend, fe.frontend_plain, fe.fused_frontend, fe.frontend_plain):
        times[fn.__name__].append(median_ms(lambda: fn(x, window, rate)))
    k_ms = min(times["fused_frontend"])
    p_ms = min(times["frontend_plain"])
    log("45-min chunk %s: kernel %.4f ms, plain %.4f ms (medians of 15, best "
        "of 2 rounds: %s)" % (shape, k_ms, p_ms, times))
    return errs, k_ms, p_ms


def _srt(spans, shift):
    def stamp(t):
        ms = int(round(t * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60, ms % 1000)

    return "".join(
        "%d\n%s --> %s\nline %d\n\n" % (i + 1, stamp(a + shift), stamp(b + shift), i + 1)
        for i, (a, b) in enumerate(spans)
    )


def synthesize(workdir):
    """The 90-minute 12 kHz speech WAV, its truth .srt and a copy shifted
    by ``TRUE_OFFSET_S``. Returns (wav path, int16 PCM)."""
    import numpy as np

    from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu.utils.fixtures import write_wav_i16

    duration = MINUTES * 60.0
    rng = np.random.RandomState(0)
    spans = []
    t = 10.0  # leaves room for the early-shifted cues
    while t < duration - 6.0:
        length = rng.uniform(1.0, 4.0)
        spans.append((t, t + length))
        t += length + rng.uniform(0.8, 4.0)
    t0 = time.perf_counter()
    wav = speech_signal_for_spans(duration, spans, RATE, speech_level=0.35)
    wav_path = os.path.join(workdir, "ref.wav")
    write_wav_i16(wav_path, wav, RATE)
    pcm = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
    del wav
    for name, shift in (("truth.srt", 0.0), ("in.srt", -TRUE_OFFSET_S)):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(_srt(spans, shift))
    log("synthesized %d min at %d Hz (%d spans) in %.1f s"
        % (MINUTES, RATE, len(spans), time.perf_counter() - t0))
    return wav_path, pcm


def _sync_argv(workdir, wav_path, label):
    vad_args = {"fused": ["--vad", "fused"], "default": []}[label]
    return [wav_path, "-i", os.path.join(workdir, "in.srt"),
            "-o", os.path.join(workdir, "out_%s.srt" % label)] + vad_args


def _timed_sync(workdir, wav_path, label):
    """One sync through the CLI entry, card idle before and after.
    Returns (result, wall seconds)."""
    import torch

    from ffsubsync_tpu.cli import make_parser
    from ffsubsync_tpu_torch import sync

    argv = _sync_argv(workdir, wav_path, label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sync.run(make_parser().parse_args(argv))
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _check_result(label, result):
    if not result.get("sync_was_successful"):
        fail("%s sync was not successful: %s" % (label, result))
    err = abs(result["offset_seconds"] - TRUE_OFFSET_S)
    if err > 0.15:
        fail("%s sync offset %.3f s, truth %.3f s"
             % (label, result["offset_seconds"], TRUE_OFFSET_S))
    return err


def main_path(workdir, wav_path):
    """Phase 4. Returns {label: (frontend launches, wall s, offset error)}."""
    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops import vad
    from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

    # instruments: chunks the detector dispatched, and what the aligner got
    dispatched = []
    seen_refs = []
    real_program = vad._vad_program
    real_align = sync.align_candidates

    def counting_program(*args, **kwargs):
        dispatched.append(1)
        return real_program(*args, **kwargs)

    def recording_align(ref, *args, **kwargs):
        seen_refs.append(ref)
        return real_align(ref, *args, **kwargs)

    vad._vad_program = counting_program
    sync.align_candidates = recording_align
    results = {}
    try:
        for label in ("fused", "default"):
            dispatched.clear()
            seen_refs.clear()
            fe.fused_frontend.launches = 0
            result, wall = _timed_sync(workdir, wav_path, label)
            launches = fe.fused_frontend.launches
            log("%s sync: %.3f s wall, result %s, frontend launches %d, chunks "
                "dispatched %d" % (label, wall, result, launches, len(dispatched)))
            err = _check_result(label, result)
            if launches == 0 or launches != len(dispatched):
                fail("%s: %d frontend kernel launches for %d dispatched chunks"
                     % (label, launches, len(dispatched)))
            if not seen_refs or not all(
                isinstance(r, LazySpeechSignal) and r.device.type == "cuda"
                for r in seen_refs
            ):
                fail("%s: labels did not reach the aligner as CUDA tensors: %r"
                     % (label, [type(r).__name__ for r in seen_refs]))
            results[label] = (launches, wall, err)
    finally:
        vad._vad_program = real_program
        sync.align_candidates = real_align
    return results


def labels_card_vs_cpu(pcm):
    """Phase 5: fused labels of the first minutes, card against CPU."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops.vad import make_fused_detector

    part = pcm[: LABEL_MINUTES * 60 * RATE]
    card = make_fused_detector(SAMPLE_RATE, RATE, 0.0, torch.device("cuda"))(part)
    host = make_fused_detector(SAMPLE_RATE, RATE, 0.0, torch.device("cpu"))(part)
    if card.shape != host.shape or card.shape[0] != LABEL_MINUTES * 60 * SAMPLE_RATE:
        fail("label shapes %r vs %r" % (card.shape, host.shape))
    if not (np.isfinite(card).all() and np.isfinite(host).all()):
        fail("non-finite labels")
    agree = float(np.mean(np.abs(card - host) < 0.05))
    log("labels card vs CPU over %d min: %.5f of windows within 0.05 (max |d| %.3g)"
        % (LABEL_MINUTES, agree, float(np.abs(card - host).max())))
    if agree < 0.995:
        fail("card and CPU labels agree on only %.4f of windows" % agree)
    return agree


def measure(workdir, wav_path, pcm, runs=6):
    """The ``--measure`` phases (see the module docstring)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.models.neural_vad import load_net
    from ffsubsync_tpu_torch.ops import vad
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    # 1. wall seconds of repeated syncs in this process
    warm_median = {}
    for label in ("fused", "default"):
        walls = []
        for _ in range(runs):
            result, wall = _timed_sync(workdir, wav_path, label)
            _check_result(label, result)
            walls.append(wall)
        warm = walls[1:]
        warm_median[label] = float(np.median(warm))
        log("wall %s: first %.4f s, warm median %.4f s (min %.4f, max %.4f, "
            "n=%d); all %s" % (label, walls[0], warm_median[label],
                               min(warm), max(warm), len(warm), walls))

    # 2. per-layer breakdown of one warm sync: each layer is bracketed by
    # torch.cuda.synchronize(), which serializes host and card
    spent = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    real = (vad.prepare_staged_input, vad._vad_program, sync.align_candidates)
    vad.prepare_staged_input = timed("host staging", real[0])
    vad._vad_program = timed("VAD programs", real[1])
    sync.align_candidates = timed("alignment search", real[2])
    try:
        for label in ("fused", "default"):
            spent.clear()
            result, wall = _timed_sync(workdir, wav_path, label)
            _check_result(label, result)
            rest = wall - sum(spent.values())
            log("breakdown %s: wall %.4f s; %s; rest (WAV read, subtitle parse "
                "and rasterize, copies, logging) %.4f s"
                % (label, wall, ", ".join("%s %.4f s" % kv for kv in spent.items()), rest))
    finally:
        vad.prepare_staged_input, vad._vad_program, sync.align_candidates = real

    # 3. one _vad_program per mode on a 45-minute chunk
    framed, rate, window, n_windows = prepare_staged_input(
        pcm[: CHUNK_SECONDS * RATE], RATE, SAMPLE_RATE
    )
    x = torch.from_numpy(framed).to("cuda")
    dev = torch.device("cuda")
    for mode in ("weighted", "webrtc", "silero"):
        net = None if mode == "webrtc" else load_net(rate, dev)
        ms = median_ms(lambda: vad._vad_program(
            x, window, rate, n_windows, vad.initial_state(dev), net, 0.0, mode
        ), n=5, warm=2)
        log("_vad_program %s, 45-min chunk [%d, %d]: %.3f ms (CUDA events, "
            "median of 5)" % (mode, n_windows, window, ms))

    # 4. torch.profiler over one warm fused sync; the first profiled run of
    # a process pays the tracer's start-up (seconds), so the second is read.
    # The busy share is taken against the unprofiled warm median of step 1.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in ("warm-up", "read"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            result = sync.run(sync.make_parser().parse_args(
                _sync_argv(workdir, wav_path, "fused")))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_result("profiled fused", result)
        log("profiled fused sync (%s): wall %.4f s" % (attempt, wall))
    averages = prof.key_averages()
    busy_s = sum(e.self_device_time_total for e in averages
                 if e.device_type == DeviceType.CUDA) / 1e6
    log("self CUDA time of device events %.4f s; card busy share %.4f of the "
        "profiled wall, %.4f of the unprofiled warm median %.4f s"
        % (busy_s, busy_s / wall, busy_s / warm_median["fused"], warm_median["fused"]))
    log(averages.table(sort_by="self_cuda_time_total", row_limit=30,
                       max_name_column_width=80))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--measure", action="store_true",
                        help="print the PERF.md measurements instead of the smoke check")
    opts = parser.parse_args()
    smi = probe()
    t_all = time.perf_counter()
    build()
    import torch

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ffs_chip_smoke_") as workdir:
        wav_path, pcm = synthesize(workdir)
        if opts.measure:
            measure(workdir, wav_path, pcm)
            log(smi)
            return
        worst = kernel_vs_plain(dev)
        chunk_errs, k_ms, p_ms = chunk_check_and_time(dev, pcm)
        results = main_path(workdir, wav_path)
    agree = labels_card_vs_cpu(pcm)
    log("phases done in %.1f s; fused 90-min sync %.3f s wall, default %.3f s "
        "wall; label agreement %.5f"
        % (time.perf_counter() - t_all, results["fused"][1], results["default"][1], agree))
    kernels = {
        "kernels": [
            {
                "name": "fused_frontend",
                "route": "cuda",
                "source": "ffsubsync_tpu_torch/csrc/frontend.cu",
                "replaces": "ffsubsync_tpu/ops/pallas/frontend.py:225",
                "launches": results["fused"][0],
                # worst log-mel abs error over every phase-3 comparison
                "max_abs_err": max(worst["logmel"], chunk_errs["logmel"]),
                # all three outputs at the main path's own chunk shape
                "chunk_max_abs_err": chunk_errs,
                "ms": k_ms,
                "plain_ms": p_ms,
            }
        ]
    }
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
