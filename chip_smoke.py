#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the PyTorch/CUDA port (ffsubsync_tpu_torch) on one GPU.

    python3 chip_smoke.py              # the smoke check below
    python3 chip_smoke.py --measure    # the PERF.md measurements instead

Run from the repository root on a machine with a CUDA card and nvcc. It
needs no network and no jax. Phases, each fatal on failure:

1. probe the card (name, capability, power limit);
2. build the CUDA kernels from ``ffsubsync_tpu_torch/csrc`` (one nvcc per
   source, all at once; timed), print ptxas's registers and spills, and
   check that the SASS (``cuobjdump -sass``) holds tensor-core MMA
   instructions (HMMA or HGMMA);
3. hold the frontend kernel against its plain PyTorch version on the card:
   every rate tier with trained weights plus the legacy 48 kHz window and
   the 220- and 441-sample windows of 22.05 and 44.1 kHz audio, every
   wire, a ragged window count, random and synthetic-speech PCM; then at
   the main path's own shape, the first 45-minute pipeline chunk of the
   synthetic 90-minute WAV as the port stages it, checked and timed beside
   its plain version and one cuBLAS float32 product of the decoded frames
   by the DFT basis (the yardstick, ``library_ms``), with its bounds; and
   the kernel timed at every path's launch shape;
4. the main path at full size: that synthetic 90-minute 12 kHz WAV synced
   to a shifted .srt through the port's CLI entry, with ``--vad fused`` and
   with the default VAD; the shift must be recovered within 0.15 s, the
   kernel must have run once per dispatched chunk, and the labels must
   reach the aligner as CUDA tensors; the scan kernel must have run 8
   times per chunk and the offset be the truth's window (7.34 s);
5. fused labels of 10 minutes of that audio, card against CPU;
6. ``--vad auditok`` on the same WAV through the CLI: one frontend launch
   for the whole signal, the shift within 0.15 s, and the card's labels
   and offset held against the port's CPU run of the same sync; the
   kernel held against its plain version at that launch's own shape, the
   whole 90 minutes staged as the auditok detector stages them;
7. ``--multi-segment-sync --vad fused`` on the same WAV (8 segments of
   60 s, 4 threads): one frontend launch per segment, shift within 0.15 s;
   the kernel held against its plain version on one segment's own input;
8. batch sync (``ffsubsync_tpu_torch.batch.sync_batch``, ``--vad fused``)
   of 10 jobs of 44 minutes (from the WAV's two halves, each job with its
   own shift; shorter than one pipeline chunk, as most episodes are): 10
   frontend launches, every shift within 0.15 s, every reference at the
   batched search as CUDA labels, and the batched search equal to one
   search per job; the batch once more with its search split over the
   mesh ``[cuda:0, cuda:0]`` (and over every card where there are two or
   more), offsets equal to the one-device run;
9. the sequence-parallel VAD (``parallel/vad_shard``) on the 90-minute
   signal: one sharded call from PCM on 4 shards of ``cuda:0`` (4
   launches, labels on the card that recover the shift within 0.15 s);
   for ``weighted``, ``webrtc`` and ``silero``, 4 and 3 shards of
   ``cuda:0`` (and every card, where there are two or more) against the
   monolithic ``_vad_program`` over the whole signal as one chunk on the
   card, the second call of each under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync from the
   staged shards to the labels); the kernel against its plain version at
   one shard's launch shape; card against CPU sharded labels on 10
   minutes; and a CLI sync with ``FFS_TPU_SP_VAD=1``, which on one card
   keeps the chunked path (the gate needs two or more cards);
10. training (``scripts/train_neural_vad``) at the shipped net's full
    width: the kernel against its plain version at the trainer's launch
    shapes (8 clips of 10 s as int16 ``[8000, 120]`` and ``[8000, 480]``,
    the held-out pass's 16 clips ``[16000, 120]``); three steps of the
    script's optimizer on the card against the same on the CPU; the
    trainer's entry in-process (``--frame-rate 12000 --steps 5``, one
    kernel launch per step and one for the held-out pass), its
    weights written in the JAX layout and driving the card's silero program
    over 10 minutes of the WAV; and ``make_vad_train_step`` over
    ``[cuda:0, cuda:0]`` (and every card, where there are two or more)
    against ``[cuda:0]``;
11. evaluation: ``scripts/eval_neural_vad.evaluate`` on every adversarial
    condition (one 30-s clip at 48 kHz each) for the silero, fused, webrtc
    and auditok backends on the card against the CPU, and
    ``scripts/eval_vad_agreement.run_synthetic`` (fused, silero, webrtc) on
    the ``clean`` and ``music_bed`` movies of 3 minutes at 12 kHz, held to
    ``check_bars``, one kernel launch per dispatched chunk and the labels
    reaching the aligner on the card; the kernel against its plain version
    on the first staged input of each (one condition clip, ``[3000, 120]``
    int8, and one movie, ``[18000, 120]`` int8);
12. raw-signal alignment (``ops.align.align_signal_pair``): a 90-minute
    pair of 0/1 signals at 100 Hz (540,000 samples each, the reference from
    the synthetic movie's spans, the subtitle side that signal shifted by a
    known offset), with ``max_offset_samples`` None and 6000, by default
    (the host branch under ``FFS_TPU_HOST_ALIGN=1`` beside it): the search
    must run on the card
    (``align_device.align_signals`` on CUDA tensors), find the offset of
    the host branch (or one whose exact score ties it) and its score within
    1e-4 relative; the search's card milliseconds are timed;
13. the three EVAL.md probe protocols, depth cut: the babble-ceiling probe
    (5 steps at batch 8 x 10 s, 12 kHz, then 2 held-out clips of 30 s per
    condition), its losses and parameters held against the same steps on
    the CPU, the kernel against its plain version at its training and
    scoring launches (``[8000, 120]`` and ``[3000, 120]`` int16); the
    noisy-jitter probe (seed 0, 3 minutes, fused and silero) in-process and
    the webrtc-bias probe (seed 1, 3 minutes, all four music scenarios) as
    a process of its own, each printed beside the committed artifact's row
    (``EVAL_noisy_jitter.json``, ``EVAL_webrtc_bias.json``; offsets from the
    synthetic truth, not speeds);
14. the port's benchmark scripts, each as a user runs it (``python -m
    ffsubsync_tpu_torch.scripts.bench``, ``.bench_batch``,
    ``.bench_suite``) in a process of its own at full size with the depth
    cut (``BENCH_SCRIPTS``): each line must hold the reference's keys
    (``BENCH_*_r05.json``) plus ``platform`` ``cuda`` and ``device``
    (phase 1's ``nvidia-smi`` line), finite times, the frontend launches
    its knobs imply, bench's offsets within 10 ms, the batch's offsets
    exact and every suite case within 0.15 s (printed beside
    ``BENCH_SUITE_r05.json``'s; wav5_energy's auditok labels leave an
    exact-tie plateau, so its case is rebuilt in-process and a pick beyond
    0.15 s passes only where it scores exactly what the truth does); the kernel held against its plain version
    at the suite's one new launch shape, wav5_energy's whole 5-minute
    signal ``[30000, 120]``, and timed beside its bound;
15. the port's stage diagnostics, each as a user runs it (``python -m
    ffsubsync_tpu_torch.scripts.diag_breakdown 90 2``, ``.diag_chunks 90
    2``, runs cut from 4) in a process of its own: every line of the JAX
    scripts with finite times and the card's ``nvidia-smi`` line, the wire
    bytes equal to the same problem staged here, the sweep's launches 1 /
    2 / 4 / 9 / 18 per setting and the frontend launches the knobs imply
    (``DIAG_SCRIPTS``); diag_breakdown's align stage rerun here, its pick
    within 0.15 s of the truth; the kernel held against its plain version
    at diag_chunks' 600-s chunk ``[60000, 120]`` and timed beside its
    bound; and phase 4's fused sync with ``--profile-dir``, whose
    ``trace.json`` must hold one frontend kernel event per launch and the
    scan kernel's events;
16. the scan kernel of the webrtc-class detector (``csrc/scan.cu``):
    the detector's program at each path's own shapes (a 45-minute chunk,
    the whole 90 minutes as one chunk, a 44-minute episode, a 60 s
    segment, and the sharded program on 4 shards of ``cuda:0``) by the
    kernel and by the plain version, the labels under the SP bounds, the
    carried state within ``SCAN_STATE_RTOL`` and every scan held against
    its plain version (``_scan_errors``), timed beside plain, one
    ``torch.cumsum`` per scan over the transposed layout and the bound;
    one ``_vad_program`` per mode on a 45-minute chunk with its scans by
    the kernel and by the plain version, in turns; and ``dispatch_async``
    of the 90 minutes for webrtc, silero and fused under
    ``torch.cuda.set_sync_debug_mode("error")``, beside the fused detector
    with the pageable copies the port made before.

Every path is driven with both kernels' launch counts set to 0 just
before and read just after. The last three lines of standard output are
one JSON object describing the kernels, the card's name and power limit,
and one JSON object ``{"ok": true, "device": {...}}``.

``--measure`` runs phases 1 and 2, synthesizes the same WAV, and then
prints what PERF.md cites: the wall seconds of repeated syncs of every
path (the 90-minute fused, default, auditok and multi-segment syncs, and
the 10-job batch), a per-layer breakdown of one warm fused and default
sync, the share of a warm batch spent in the batched search, the device
milliseconds of one ``_vad_program`` per mode on a 45-minute chunk, and a
``torch.profiler`` table of one warm fused sync.
"""
import argparse
import json
import os
import re
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
SEGMENTS = 8  # --multi-segment-sync's default count (60 s each)
EPISODE_SECONDS = 2640  # a batch job: 44 min, shorter than one chunk
# batch jobs: (half of the 90-min WAV, true shift in seconds)
BATCH_JOBS = [(i % 2, shift) for i, shift in enumerate(
    (-4.1, -2.6, 0.9, 2.3, 3.7, 5.05, 6.4, 7.8, -1.15, 4.55))]
# reference tolerances (tests/test_pallas_frontend.py): (rtol, atol)
TOLS = {"logmel": (2e-3, 2e-3), "bands": (2e-3, 1e-5), "total": (1e-4, 0.0)}
SP_SHARDS = (4, 3)  # phase 9: meshes that repeat cuda:0
SP_MODES = ("weighted", "webrtc", "silero")
# sharded against monolithic labels: more than SP_AGREEMENT of windows
# within SP_TOL (tests/test_vad_shard.py's bar). That test also wants no
# window SP_MAX_DIFF or more apart, which holds at its 6,400 windows but not
# at 540,000: there float32 rounding flips a few hard webrtc votes, in the
# monolithic program as well (15 flips against a float64 run of it on the
# CPU, the 4-shard program 6), so at most SP_FLIPS of windows may differ by
# a whole vote
SP_TOL, SP_AGREEMENT, SP_MAX_DIFF, SP_FLIPS = 0.02, 0.999, 0.05, 1e-4
# phase 10: the trainer's launch shapes, (rate, clips of TRAIN_CLIP_S, seed):
# its batch (its defaults) at 12 and 48 kHz, and its held-out pass (16
# clips of seed + 1); the in-process run takes TRAIN_STEPS steps (each
# check holds at a few; more would only add the host's synthesis)
TRAIN_SHAPES = ((12000, 8, 0), (48000, 8, 0), (12000, 16, 1))
TRAIN_CLIP_S, TRAIN_STEPS = 10.0, 5
# card against CPU, three steps of the script's optimizer at 12 kHz under
# the schedule of a TRAIN_LR_STEPS-step run (learning rates 0, 1e-3,
# 2e-3): the per-step loss relative, and the
# parameters within TRAIN_PARAM_TOL on TRAIN_PARAM_SHARE of the entries and
# within twice the summed learning rates on all. The kernel's features
# differ from the plain ones by up to TOLS, and Adam's normalized step lets
# an entry whose gradient is near zero step either way. Measured on one
# H100: losses 1.46e-3 apart, 0.99604 of the parameters within 1e-4, the
# largest difference 3.6e-3 of the 6e-3 allowed
TRAIN_LR_STEPS, TRAIN_LOSS_REL, TRAIN_PARAM_TOL, TRAIN_PARAM_SHARE = 30, 5e-3, 1e-4, 0.99
# mesh against one device (tests/test_torch_train.py's bounds)
MESH_LOSS_REL, MESH_PARAM_TOL, MESH_PARAM_SHARE = 1e-4, 1e-5, 0.99
# phase 11: one clip per adversarial condition, and the agreement movies
EVAL_SECONDS, EVAL_RATE, EVAL_ACC_TOL = 30.0, 48000, 0.01
EVAL_BACKENDS = ("silero", "fused", "webrtc", "auditok")
AGREE_VADS, AGREE_SCENARIOS, AGREE_MINUTES = ("fused", "silero", "webrtc"), ("clean", "music_bed"), 3.0
# phase 12: the subtitle signal is the reference shifted by PAIR_SHIFT
# samples (10 ms each); each search with these max_offset_samples; the
# card's score against the host's, relative
PAIR_SHIFT, PAIR_MAX_OFFSETS, PAIR_SCORE_REL = 734, (None, 6000), 1e-4
# phase 13: the babble probe's steps and scoring clips per condition (its
# defaults are 900 and 6); the jitter and bias probes' seed, length, VADs
BABBLE_STEPS, BABBLE_SCORE_CLIPS = 5, 2
JITTER_SEED, JITTER_MINUTES, JITTER_VADS = 0, 3.0, ("fused", "silero")
BIAS_SEED, BIAS_MINUTES = 1, 3.0
# the babble probe's 5 steps card against CPU: the losses relative, the
# parameters within TRAIN_PARAM_TOL on BABBLE_PARAM_SHARE of the entries
# and within twice the summed learning rates on all. The trajectories part
# a little more with each step (kernel against plain features, then Adam);
# measured on one NVIDIA H100 80GB HBM3, 700.00 W: losses 2e-5, 2e-5,
# 2.5e-3, 3.7e-3 and 5.3e-3 apart, 0.99845 of the parameters within 1e-4,
# the largest difference 8.6e-4 of 5.2e-3
BABBLE_LOSS_REL, BABBLE_PARAM_SHARE = 1e-2, 0.99
# the planted fault both checks must reject: the same steps on the card with
# this step's update reversed (the 0-based step index; the first steps'
# rates are 0 under the warm-up). Measured on one NVIDIA H100 80GB HBM3,
# 700.00 W: the fault's last loss 1.18 relative from the CPU's (the sound
# run's 5.3e-3; bound 1e-2), 0.103 of its parameters within 1e-4 (the sound
# run's 0.99845; bound 0.99)
BABBLE_FAULT_STEP = 3
# phase 14: the port's benchmark scripts at full size, depth cut: (module,
# knobs, the frontend launches they imply). bench: 2 pipeline chunks per
# 90-min sync x (warm-up + BENCH_RUNS timed + attributed + BENCH_VAD_RUNS
# VAD-only) + 2 CLI syncs x 2 chunks = 14; bench_batch's references are
# 0/1 signals (no kernel); bench_suite: srt_srt none, wav5_energy one
# launch over the whole signal per run, multiseg one per segment = 0 + 1 + 8
BENCH_SCRIPTS = (
    ("bench", {"BENCH_RUNS": "2", "BENCH_MAX_RUNS": "2", "BENCH_VAD_RUNS": "1"},
     2 * (1 + 2 + 1 + 1) + 2 * 2),
    ("bench_batch", {"BENCH_RUNS": "2"}, 0),
    ("bench_suite", {"BENCH_RUNS": "1"}, 0 + 1 + 8),
)
BENCH_ARTIFACTS = {"bench": "BENCH_r05.json", "bench_batch": "BENCH_BATCH_r05.json",
                   "bench_suite": "BENCH_SUITE_r05.json"}
# bench's offsets within one 100 Hz window (phase 4 recovers the same 7.34 s
# shift exactly); the suite's within the reference's audio tests' bar (its
# wav5_energy carries auditok's 80 ms onset bias, ROADMAP C1)
BENCH_OFFSET_MS, SUITE_OFFSET_MS = 10.0, 150.0
WAV5_WINDOWS = 5 * 60 * SAMPLE_RATE
# phase 15: the stage diagnostics at full size, each a process of its own
# with its runs cut to DIAG_RUNS (default 4). diag_chunks' sweep cuts the
# 90 minutes into DIAG_SWEEP_CHUNKS chunks per setting of
# FFS_TPU_PIPELINE_SECONDS. The frontend launches their knobs imply:
# diag_breakdown's 2 chunks per pass x (3 modes x (warm + runs) + the
# align stage's pass + one pass per pull) = 4·2·(1 + runs); diag_chunks'
# (warm + runs) passes per setting
DIAG_RUNS = 2
DIAG_SWEEP_CHUNKS = {"0": 1, "2700": 2, "1350": 4, "600": 9, "300": 18}
DIAG_LAUNCHES = {"diag_breakdown": 4 * 2 * (1 + DIAG_RUNS),
                 "diag_chunks": (1 + DIAG_RUNS) * sum(DIAG_SWEEP_CHUNKS.values())}
# the one new launch shape: diag_chunks' 600-s chunk
CHUNKS600_WINDOWS = 600 * SAMPLE_RATE
# phase 16: the scan kernel at each path's own shapes, in windows of
# the detector: a 45-minute pipeline chunk (fused, default), the whole 90
# minutes as one chunk (FFS_TPU_PIPELINE_SECONDS=0), a 44-minute batch
# episode and a 60 s segment; the sharded program's scans on 4 shards of
# cuda:0 beside them ("sp")
SCAN_PATHS = {"fused": 270000, "whole": 540000, "batch": 264000, "multiseg": 6000}
SCANS_PER_PROGRAM = 8  # the detector's scans per chunk (or per shard)
# each scan of the kernel against its plain version on the same inputs:
# min and max exact; add and the affine pair within SCAN_RTOL of the
# largest |plain| of the output, and the kernel no farther from a float64
# scan than the plain version (or within 1e-6 of max |plain|). The plain
# prefix sums run one thread per column down all the rows in float32 and
# drift: at 540,000 windows they lay 1.7e-4 of max |plain| from float64,
# the kernel's two-level sums 2e-7 (one NVIDIA H100 80GB HBM3, 700.00 W).
# The detector's labels under the SP bounds above and its carried state
# within SCAN_STATE_RTOL (tests/test_torch_webrtc.py's)
SCAN_RTOL, SCAN_STATE_RTOL = 1e-3, 1e-4
SCAN_PATH_LAUNCHES = {}  # scan-kernel launches of each driven path
VAD_MODES = ("webrtc", "silero", "weighted")  # the _vad_program timings

HERE = os.path.dirname(os.path.abspath(__file__))


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
    """Phase 2. Returns (ptxas report lines, spilled bytes, tensor-core MMA
    instructions in the SASS)."""
    from ffsubsync_tpu_torch.ops import _build

    result = _build.build_library()
    log("build: %.2f s -> %s" % (result.seconds, os.path.relpath(result.path)))
    # one line per kernel instantiation: frontend_kernel<rows, warp
    # columns, resident basis> or scan_tiles<op, pass> and scan_totals<op>,
    # its registers and spilled bytes
    ptxas, name, spills = [], "?", 0
    for line in result.log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            args = re.search(r"ILi(\d+)ELi(\d+)ELb([01])E", entry.group(1))
            scan_op = re.search(r"(scan_tiles|scan_totals)I\w*?(AddF32|MinF32|MaxF32|MinI32|"
                                r"MaxI32|AffineF32)E(?:Li(\d)E)?", entry.group(1))
            if args:
                name = "frontend_kernel<%s,%s,%s>" % args.groups()
            elif scan_op:
                name = "%s<%s>" % (scan_op.group(1), ",".join(g for g in scan_op.groups()[1:] if g))
            else:
                name = entry.group(1)
        for n in re.findall(r"(\d+) bytes spill", line):
            spills += int(n)
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            ptxas.append("%s: %s registers" % (name, regs.group(1)))
            log("  ptxas:", ptxas[-1])
    log("ptxas: %d bytes of register spills over all kernels" % spills)
    # the frontend kernel must run on the tensor cores: mma.sync is HMMA in
    # SASS (wgmma would be HGMMA)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", result.path], capture_output=True,
                          text=True, check=True).stdout
    mma = sum(1 for line in sass.splitlines() if "HMMA" in line or "HGMMA" in line)
    log("sass: %d tensor-core MMA instructions (HMMA/HGMMA) in %s"
        % (mma, os.path.basename(result.path)))
    if mma == 0:
        fail("no tensor-core MMA instruction in the kernels' SASS")
    _build.load_library()
    return ptxas, spills, mma


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

    from ffsubsync_tpu_torch import native
    from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu_torch.ops import frontend as fe

    rng = np.random.RandomState(0)
    worst = {k: 0.0 for k in TOLS}
    n_windows = 1037  # ragged: no multiple of any tile
    # the rate tiers with weights, the legacy 48 kHz window, and the windows
    # of 22.05 and 44.1 kHz audio (which the analysis rate keeps as they
    # are: 220 and an odd 441)
    for rate in (8000, 12000, 16000, 24000, 48000, 22050, 44100):
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


def host_ms(fn, n=15, warm=3, calls=1):
    """Median host milliseconds per call of issuing ``fn()``, ``calls``
    calls back to back with no wait on the card between them (the host's
    clock; the card is synchronized after each sample). Beside
    :func:`median_ms` it says whether the card or the host sets a short
    kernel's time."""
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        samples.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return float(np.median(samples))


def median_ms(fn, n=15, warm=3, calls=1):
    """Median milliseconds per call of ``fn()`` between two CUDA events,
    over ``n`` samples of ``calls`` calls back to back. With several calls
    the host's work for the next call overlaps the card's work on this one,
    as on a busy stream, so a kernel's time is its time on the card."""
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    samples = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return float(np.median(samples))


KERNEL_CALLS = 10  # calls per timing sample of the frontend, plain and library


# the frontend kernel's launch shape on each path, in windows of 12 kHz
# mu-law int8 [T, 120]: a 45-minute pipeline chunk (fused, default), the
# whole 90 minutes (auditok), a 60 s segment, a 44-minute batch episode and
# one of 4 shards of the 90 minutes (sp)
PATH_WINDOWS = {"fused": 270000, "auditok": 540000, "multiseg": 6000,
                "batch": 264000, "sp": 135000}
# peaks of one H100 SXM (NVIDIA's data sheet): float32 on the CUDA
# cores, TF32 on the tensor cores, memory
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12


def frontend_bounds(n_windows, window, frame_rate, row_bytes, n_cols):
    """The least time the card could take for the frontend's work on
    ``n_windows`` windows, in ms: operations at the float32 peak (what the
    function needs as a DFT: one real DFT of ``F`` bins, a multiply-add by
    cos and by sin per sample and bin, since the Hann spectrum follows from
    the plain one's neighbours; that identity; both powers; the band sums;
    a multiply-add per nonzero mel weight; the logs; the total power) and
    bytes (the wire read once, 47 floats written per window). Beside them,
    as a figure of the design and not a bound, the kernel's own 3xTF32
    product [T, kp] x [kp, n_cols] at the TF32 peak."""
    from ffsubsync_tpu_torch.ops import frontend as fe

    f = window // 2 + 1
    _, _, mel_weights = fe.mel_ranges(frame_rate, window)
    bands = fe._band_ranges(frame_rate, window)
    band_bins = sum(hi - lo for lo, hi in zip(bands[:fe.N_BANDS], bands[fe.N_BANDS:]))
    per_window = (4 * window * f  # the DFT
                  + 8 * f  # Hann from neighbours: an add, a scale, a multiply-add, x2
                  + 6 * f  # two powers: a multiply and a multiply-add each
                  + band_bins + 2 * len(mel_weights)
                  + 2 * fe.N_MELS  # + 1e-6 and log
                  + 2 * window + 1)  # the total power
    ops = n_windows * per_window
    nbytes = n_windows * (row_bytes + 47 * 4)
    tf32 = 3 * 2 * n_windows * (-(-window // 8) * 8) * n_cols
    return {"ops_ms": ops / PEAK_F32 * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3,
            "tf32_ms": tf32 / PEAK_TF32 * 1e3, "gflop": ops / 1e9, "mbytes": nbytes / 1e6}


def _staged(pcm, windows):
    """The first ``windows`` 10 ms windows of ``pcm`` staged as the port
    stages them, on the card."""
    import torch

    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    framed, rate, window, n = prepare_staged_input(pcm[: windows * (RATE // SAMPLE_RATE)],
                                                   RATE, SAMPLE_RATE)
    if (rate, window, n) != (RATE, RATE // SAMPLE_RATE, windows):
        fail("staged %d windows as %r at %d Hz" % (windows, framed.shape, rate))
    return torch.from_numpy(framed).to("cuda")


def _shape(x):
    return "[%d, %d] %s" % (x.shape[0], x.shape[1], str(x.dtype).replace("torch.", ""))


def chunk_check_and_time(dev, pcm):
    """Phase 3 at the main path's shape: the first 45-minute chunk of the
    synthetic speech, staged as the port stages it (12 kHz, default mu-law
    wire), through kernel and plain version. Checks the two agree, then
    times both, and one cuBLAS float32 product of the decoded frame by the
    [W, 2F] cos | sin basis (the yardstick of the DFT product alone; the
    port never calls it). Then times the kernel at every path's launch
    shape. Returns a dict of what it measured."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe

    x = _staged(pcm, PATH_WINDOWS["fused"])
    window = RATE // SAMPLE_RATE
    got = fe.fused_frontend(x, window, RATE)
    torch.cuda.synchronize()
    errs = compare(got, fe.frontend_plain(x, window, RATE), "45-min speech chunk " + _shape(x))
    del got
    f = window // 2 + 1
    basis = torch.from_numpy(fe.dft_basis(window, 2 * f)[:window].astype(np.float32)).to(dev)
    decoded = fe.wire_to_frame(x, window)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls may use TF32: the yardstick would not be float32")
    times = {"fused_frontend": [], "frontend_plain": [], "library": []}
    fns = {"fused_frontend": lambda: fe.fused_frontend(x, window, RATE),
           "frontend_plain": lambda: fe.frontend_plain(x, window, RATE),
           "library": lambda: torch.matmul(decoded, basis)}
    for name in ("fused_frontend", "frontend_plain", "library") * 2:
        times[name].append(median_ms(fns[name], calls=KERNEL_CALLS))
    best = {k: min(v) for k, v in times.items()}
    log("45-min chunk %s: kernel %.4f ms, plain %.4f ms, cuBLAS float32 [%d, %d] x [%d, %d] "
        "%.4f ms (per call, %d calls back to back; medians of 15, best of 2 rounds: %s)"
        % (_shape(x), best["fused_frontend"], best["frontend_plain"], x.shape[0], window,
           window, 2 * f, best["library"], KERNEL_CALLS, times))
    del decoded
    by_path = {}
    for label, windows in PATH_WINDOWS.items():
        xp = x if windows == x.shape[0] else _staged(pcm, windows)
        by_path[label] = median_ms(lambda: fe.fused_frontend(xp, window, RATE),
                                   calls=KERNEL_CALLS)
        log("  kernel at %-8s launch shape %s: %.4f ms" % (label, _shape(xp), by_path[label]))
    cfg = fe.kernel_config(window, fe.wire_kind(x, window))
    bounds = frontend_bounds(x.shape[0], window, RATE, x.shape[1], cfg.n_cols)
    log("bounds at %s: %.4f ms of float32 operations (%.2f GFLOP at 67 TFLOP/s), %.4f ms "
        "of bytes (%.1f MB at 3.35 TB/s); the kernel at %.1f%% of the larger; its own 3xTF32 "
        "product %.4f ms at 495 TFLOP/s; config %r"
        % (_shape(x), bounds["ops_ms"], bounds["gflop"], bounds["bytes_ms"], bounds["mbytes"],
           100 * max(bounds["ops_ms"], bounds["bytes_ms"]) / best["fused_frontend"],
           bounds["tf32_ms"], tuple(cfg)))
    return {"errs": errs, "ms": best["fused_frontend"], "plain_ms": best["frontend_plain"],
            "library_ms": best["library"], "ms_by_path": by_path, "bounds": bounds,
            "config": cfg._asdict()}


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
    by ``TRUE_OFFSET_S``. Returns (wav path, int16 PCM, truth spans)."""
    import numpy as np

    from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
    from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

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
    return wav_path, pcm, spans


def _sync_argv(workdir, wav_path, label):
    vad_args = {
        "fused": ["--vad", "fused"],
        "default": [],
        "auditok": ["--vad", "auditok"],
        "multiseg": ["--multi-segment-sync", "--vad", "fused"],
    }[label]
    return [wav_path, "-i", os.path.join(workdir, "in.srt"),
            "-o", os.path.join(workdir, "out_%s.srt" % label)] + vad_args


def _timed_sync(workdir, wav_path, label):
    """One sync through the CLI entry, card idle before and after.
    Returns (result, wall seconds)."""
    import torch

    from ffsubsync_tpu_torch.cli import make_parser
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


class Instruments:
    """What one driven path did. On entry both kernels' launch counts are
    set to 0 and wrappers start to record each ``_vad_program`` call (and
    the first one's staged input, ``first_input``) and what the single and
    batched searches received and returned; on exit the counts are read
    (``launches``: the frontend kernel's; ``scan_launches``: the scan
    kernel's, kept in ``SCAN_PATH_LAUNCHES[label]`` where a label is given)
    and the wrappers are removed."""

    def __init__(self, label=None):
        self.label = label

    def __enter__(self):
        from ffsubsync_tpu_torch import sync
        from ffsubsync_tpu_torch.ops import frontend as fe
        from ffsubsync_tpu_torch.ops import scan
        from ffsubsync_tpu_torch.ops import vad
        from ffsubsync_tpu_torch.parallel.batch import BatchAligner

        self.programs, self.searches, self.batches = [], [], []
        self.first_input = None
        self._real = (vad._vad_program, sync.align_candidates, BatchAligner.align_batch)
        real_program, real_align, real_batch = self._real

        def program(*args, **kwargs):
            if not self.programs:
                self.first_input = args[:3]  # (framed, window, frame_rate)
            self.programs.append(1)
            return real_program(*args, **kwargs)

        def align(ref, candidates, *args, **kwargs):
            out = real_align(ref, candidates, *args, **kwargs)
            self.searches.append((ref, list(candidates), out))
            return out

        def batch(aligner, refs, candidates, **kwargs):
            out = real_batch(aligner, refs, candidates, **kwargs)
            self.batches.append((list(refs), [list(c) for c in candidates], kwargs, out))
            return out

        vad._vad_program, sync.align_candidates, BatchAligner.align_batch = program, align, batch
        fe.fused_frontend.launches = 0
        scan.launches = 0
        return self

    def __exit__(self, *exc):
        from ffsubsync_tpu_torch import sync
        from ffsubsync_tpu_torch.ops import frontend as fe
        from ffsubsync_tpu_torch.ops import scan
        from ffsubsync_tpu_torch.ops import vad
        from ffsubsync_tpu_torch.parallel.batch import BatchAligner

        self.launches = fe.fused_frontend.launches
        self.scan_launches = scan.launches
        if self.label is not None:
            SCAN_PATH_LAUNCHES[self.label] = self.scan_launches
        vad._vad_program, sync.align_candidates, BatchAligner.align_batch = self._real
        return False


def _on_card(refs, what):
    from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

    if not refs or not all(
        isinstance(r, LazySpeechSignal) and r.device.type == "cuda" for r in refs
    ):
        fail("%s: labels did not reach the aligner as CUDA tensors: %r"
             % (what, [type(r).__name__ for r in refs]))


def main_path(workdir, wav_path):
    """Phase 4. Returns {label: (frontend launches, wall s, offset error)}."""
    results = {}
    for label in ("fused", "default"):
        with Instruments(label) as ins:
            result, wall = _timed_sync(workdir, wav_path, label)
        log("%s sync: %.3f s wall, result %s, frontend launches %d, scan launches %d, "
            "chunks dispatched %d" % (label, wall, result, ins.launches, ins.scan_launches,
                                      len(ins.programs)))
        err = _check_result(label, result)
        if ins.launches == 0 or ins.launches != len(ins.programs):
            fail("%s: %d frontend kernel launches for %d dispatched chunks"
                 % (label, ins.launches, len(ins.programs)))
        _check_scans(label, ins.scan_launches, len(ins.programs))
        _on_card([ref for ref, _c, _o in ins.searches], label)
        results[label] = (ins.launches, wall, err)
    return results


def _exact_score(labels, spec, offset):
    """The search's score of one (candidate, offset), in float64 on the host."""
    import numpy as np

    from ffsubsync_tpu_torch.ops.align import next_pow2

    n = next_pow2(len(labels) + spec.n_samples)
    ref = np.zeros(n)
    ref[: len(labels)] = 2.0 * np.asarray(labels, np.float64) - 1.0
    sub = np.zeros(n)
    sub[: spec.n_samples] = 2.0 * spec.materialize() - 1.0
    return float(np.dot(sub, np.roll(ref, -offset)))


def _pick(search):
    """The (candidate, alignment) a one-search sync chose."""
    _ref, candidates, out = search
    best = max(range(len(out)), key=lambda i: out[i].score)
    return candidates[best], out[best]


def auditok_phase(workdir, wav_path, pcm, dev):
    """Phase 6. Returns (launches, wall s, offset error, label agreement,
    kernel-vs-plain abs errors at the launch's own shape)."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    with Instruments("auditok") as ins:
        result, wall = _timed_sync(workdir, wav_path, "auditok")
    log("auditok sync: %.3f s wall, result %s, frontend launches %d"
        % (wall, result, ins.launches))
    err = _check_result("auditok", result)
    if ins.launches != 1:
        fail("auditok: %d frontend kernel launches for the whole signal, not 1" % ins.launches)
    _check_scans("auditok", ins.scan_launches, 0)  # the host tokenizer scans nothing
    _on_card([ref for ref, _c, _o in ins.searches], "auditok")
    # the same sync by the port on the CPU (frontend_plain, host tokenizer)
    chosen = os.environ.get("FFS_TORCH_DEVICE")
    os.environ["FFS_TORCH_DEVICE"] = "cpu"
    try:
        with Instruments() as cpu:
            cpu_result, cpu_wall = _timed_sync(workdir, wav_path, "auditok")
    finally:
        if chosen is None:
            del os.environ["FFS_TORCH_DEVICE"]
        else:
            os.environ["FFS_TORCH_DEVICE"] = chosen
    card_labels = np.asarray(ins.searches[0][0])
    cpu_labels = np.asarray(cpu.searches[0][0])
    if card_labels.shape != (MINUTES * 60 * SAMPLE_RATE,) or card_labels.shape != cpu_labels.shape:
        fail("auditok label shapes %r (card) vs %r (CPU)" % (card_labels.shape, cpu_labels.shape))
    close = np.abs(card_labels - cpu_labels) < 0.05
    head = LABEL_MINUTES * 60 * SAMPLE_RATE
    log("auditok labels card vs CPU: %.6f of %d windows within 0.05 (first %d min "
        "%.6f); CPU sync %.3f s wall, result %s"
        % (close.mean(), len(close), LABEL_MINUTES, close[:head].mean(), cpu_wall, cpu_result))
    if close[:head].mean() < 0.995 or close.mean() < 0.995:
        fail("auditok card and CPU labels agree on only %.4f of windows" % close.mean())
    if cpu_result["framerate_scale_factor"] != result["framerate_scale_factor"]:
        fail("auditok scale %r on the card, %r on the CPU"
             % (result["framerate_scale_factor"], cpu_result["framerate_scale_factor"]))
    if cpu_result["offset_seconds"] != result["offset_seconds"]:
        # hard 0/1 labels can leave exact ties, whose pick float32 FFT
        # rounding decides (ROADMAP C4): accept only an exact tie
        scores = []
        for search in (ins.searches[0], cpu.searches[0]):
            spec, alignment = _pick(search)
            scores.append(_exact_score(card_labels, spec, alignment.offset))
        log("auditok offsets differ (card %r, CPU %r); exact scores %r"
            % (result["offset_seconds"], cpu_result["offset_seconds"], scores))
        if scores[0] != scores[1]:
            fail("auditok offset differs from the CPU port's and is no exact tie")
    # the one launch's input: the whole signal, staged as compute_frontend
    # stages it for the auditok detector
    framed, rate, window, n_windows = prepare_staged_input(pcm, RATE, SAMPLE_RATE)
    if n_windows != MINUTES * 60 * SAMPLE_RATE:
        fail("auditok: the whole signal staged as %d windows" % n_windows)
    x = torch.from_numpy(framed).to(dev)
    got = fe.fused_frontend(x, window, rate)
    torch.cuda.synchronize()
    errs = compare(got, fe.frontend_plain(x, window, rate),
                   "auditok whole signal [%d, %d] %s" % (x.shape[0], x.shape[1],
                                                         str(x.dtype).replace("torch.", "")))
    return ins.launches, wall, err, float(close.mean()), errs


def multiseg_phase(workdir, wav_path):
    """Phase 7. Returns (launches, wall s, offset error, kernel-vs-plain abs
    errors on the first dispatched segment's own input)."""
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe

    with Instruments("multiseg") as ins:
        result, wall = _timed_sync(workdir, wav_path, "multiseg")
    log("multi-segment sync: %.3f s wall, result %s, frontend launches %d, "
        "segments dispatched %d" % (wall, result, ins.launches, len(ins.programs)))
    err = _check_result("multi-segment", result)
    if ins.launches != SEGMENTS or len(ins.programs) != SEGMENTS:
        fail("multi-segment: %d frontend launches for %d dispatched segments (want %d)"
             % (ins.launches, len(ins.programs), SEGMENTS))
    _check_scans("multi-segment", ins.scan_launches, SEGMENTS)
    x, window, rate = ins.first_input
    if x.device.type != "cuda" or x.shape[0] != 60 * SAMPLE_RATE:
        fail("multi-segment: a segment staged as %r on %s" % (tuple(x.shape), x.device))
    got = fe.fused_frontend(x, window, rate)
    torch.cuda.synchronize()
    errs = compare(got, fe.frontend_plain(x, window, rate),
                   "60 s segment [%d, %d] %s" % (x.shape[0], x.shape[1],
                                                 str(x.dtype).replace("torch.", "")))
    return ins.launches, wall, err, errs


def make_batch_jobs(workdir, pcm, spans):
    """Two 44-minute WAVs (the first 44 minutes of each of the synthetic
    WAV's halves) and one shifted .srt per job of ``BATCH_JOBS``, cues from
    its episode's own truth spans."""
    from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

    wavs = []
    for h in range(2):
        lo = h * CHUNK_SECONDS * RATE
        wavs.append(os.path.join(workdir, "episode%d.wav" % h))
        write_wav_i16(wavs[-1], pcm[lo : lo + EPISODE_SECONDS * RATE], RATE)
    jobs = []
    for i, (h, shift) in enumerate(BATCH_JOBS):
        lo = h * CHUNK_SECONDS
        cues = [(a - lo, b - lo) for a, b in spans
                if a - lo - shift >= 0.5 and b - lo - shift <= EPISODE_SECONDS - 1.0]
        srt = os.path.join(workdir, "job%d.srt" % i)
        with open(srt, "w") as f:
            f.write(_srt(cues, -shift))
        jobs.append((wavs[h], srt, os.path.join(workdir, "job%d.out.srt" % i)))
    return jobs


def _timed_batch(jobs, mesh=None):
    import torch

    from ffsubsync_tpu_torch.batch import sync_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sync_batch(jobs, vad="fused", mesh=mesh)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _check_batch(results):
    errs = []
    for r, (_h, shift) in zip(results, BATCH_JOBS):
        if r["error"] or not r["sync_was_successful"]:
            fail("batch job %s failed: %s" % (r["srtin"], r))
        errs.append(abs(r["offset_seconds"] - shift))
        if errs[-1] > 0.15:
            fail("batch job %s offset %.3f s, truth %.3f s" % (r["srtin"], r["offset_seconds"], shift))
    return max(errs)


def batch_phase(jobs):
    """Phase 8. Returns (launches, wall s, worst offset error)."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops.align import align_candidates

    with Instruments("batch") as ins:
        results, wall = _timed_batch(jobs)
    log("batch of %d x %d min: %.3f s wall, offsets %s, frontend launches %d, chunks "
        "dispatched %d" % (len(jobs), EPISODE_SECONDS // 60, wall,
                           [r["offset_seconds"] for r in results], ins.launches, len(ins.programs)))
    err = _check_batch(results)
    if ins.launches != len(jobs) or len(ins.programs) != len(jobs):
        fail("batch: %d frontend launches for %d dispatched chunks (want %d)"
             % (ins.launches, len(ins.programs), len(jobs)))
    _check_scans("batch", ins.scan_launches, len(jobs))
    if len(ins.batches) != 1:
        fail("batch: %d batched searches, not 1" % len(ins.batches))
    refs, candidates, kwargs, batched = ins.batches[0]
    _on_card(refs, "batch")
    # the batched search against one search per job, on the card
    worst = 0.0
    for ref, cands, got in zip(refs, candidates, batched):
        single = align_candidates(ref, cands, kwargs["max_offset_samples"],
                                  device=torch.device("cuda"))
        if [a.offset for a in single] != [a.offset for a in got]:
            fail("batched offsets %r, single %r" % ([a.offset for a in got],
                                                    [a.offset for a in single]))
        for a, b in zip(got, single):
            rel = abs(a.score - b.score) / max(abs(b.score), 1e-9)
            worst = max(worst, rel)
            if rel > 1e-5:
                fail("batched score %r, single %r" % (a.score, b.score))
    log("batched search = %d single searches on the card: offsets equal, worst "
        "score rel diff %.3g; worst batch offset error %.3f s"
        % (len(refs), worst, err))
    # the search split over a mesh: each job's result is the one-device one
    offsets = [r["offset_seconds"] for r in results]
    for mesh in [[torch.device("cuda", 0)] * 2] + _distinct_cards():
        meshed, mesh_wall = _timed_batch(jobs, mesh)
        if [r["offset_seconds"] for r in meshed] != offsets:
            fail("batch offsets on mesh %s: %r, one device: %r"
                 % (mesh, [r["offset_seconds"] for r in meshed], offsets))
        log("batch with its search over %s: %.3f s wall, offsets equal to the "
            "one-device run" % ([str(d) for d in mesh], mesh_wall))
    return ins.launches, wall, err


def _distinct_cards():
    """A mesh of every card, where there are two or more (copies between
    GPUs), as a list of zero or one mesh."""
    import torch

    n = torch.cuda.device_count()
    return [[torch.device("cuda", i) for i in range(n)]] if n >= 2 else []


def _close_labels(got, want, what):
    """Sharded labels against a yardstick under the SP bounds; fails outside
    them. Returns (windows SP_MAX_DIFF or more apart, largest difference of
    the others)."""
    import numpy as np

    if got.shape != want.shape or not np.isfinite(got).all():
        fail("%s: shape %r against %r, or non-finite labels" % (what, got.shape, want.shape))
    diff = np.abs(got - want)
    agree = float(np.mean(diff < SP_TOL))
    flips = int(np.sum(diff >= SP_MAX_DIFF))
    log("  %s: %.6f of %d windows within %g, max |d| %.3g; %d windows %g or more "
        "apart (at %s), max |d| of the others %.3g"
        % (what, agree, len(diff), SP_TOL, float(diff.max()), flips, SP_MAX_DIFF,
           np.nonzero(diff >= SP_MAX_DIFF)[0][:20].tolist(),
           float(diff[diff < SP_MAX_DIFF].max())))
    if agree <= SP_AGREEMENT or flips > SP_FLIPS * len(diff):
        fail("%s: labels outside the bounds" % what)
    return flips, float(diff[diff < SP_MAX_DIFF].max())


def sp_phase(pcm, spans):
    """Phase 9, the sharded VAD. Returns (launches of the one counted call
    from PCM, kernel-vs-plain abs errors at one shard's launch shape, and
    against the monolithic program the most windows of one comparison a
    vote apart and the largest difference of the others)."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.subs.raster import rasterize_intervals
    from ffsubsync_tpu_torch.models.neural_vad import load_net
    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops import scan
    from ffsubsync_tpu_torch.ops import vad
    from ffsubsync_tpu_torch.ops.align import align_candidates
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input
    from ffsubsync_tpu_torch.parallel import vad_shard

    card = torch.device("cuda", 0)
    meshes = [[card] * d for d in SP_SHARDS] + _distinct_cards()
    n_windows = MINUTES * 60 * SAMPLE_RATE

    # the path as a caller of make_sharded_detector drives it: PCM in, lazy
    # labels out, one launch per shard
    det = vad_shard.make_sharded_detector(meshes[0], "weighted", SAMPLE_RATE, RATE, 0.0)
    torch.cuda.synchronize()
    fe.fused_frontend.launches = 0
    scan.launches = 0
    t0 = time.perf_counter()
    signal = det(pcm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fe.fused_frontend.launches
    SCAN_PATH_LAUNCHES["sp"] = scan.launches
    log("sharded VAD, weighted, %d shards of %s: %.4f s wall from PCM (staging "
        "included), frontend launches %d, scan launches %d"
        % (len(meshes[0]), card, wall, launches, SCAN_PATH_LAUNCHES["sp"]))
    if launches != len(meshes[0]):
        fail("sharded call: %d frontend launches for %d shards" % (launches, len(meshes[0])))
    _check_scans("sharded call", SCAN_PATH_LAUNCHES["sp"], len(meshes[0]))
    if signal.device != card or len(signal) != n_windows:
        fail("sharded labels: %d windows on %s" % (len(signal), signal.device))
    cand = rasterize_intervals([(a - TRUE_OFFSET_S, b - TRUE_OFFSET_S) for a, b in spans],
                               SAMPLE_RATE)
    (found,) = align_candidates(signal, [cand], max_offset_samples=60 * SAMPLE_RATE)
    shift_err = abs(found.offset / SAMPLE_RATE - TRUE_OFFSET_S)
    log("sharded labels through align_candidates: offset %.2f s, truth %.2f s"
        % (found.offset / SAMPLE_RATE, TRUE_OFFSET_S))
    if shift_err > 0.15:
        fail("sharded labels recover %.3f s, truth %.3f s"
             % (found.offset / SAMPLE_RATE, TRUE_OFFSET_S))

    # every mode and mesh against the monolithic program: the whole signal
    # as one chunk on the card, fresh state
    framed, rate, window, n = prepare_staged_input(pcm, RATE, SAMPLE_RATE)
    whole = torch.from_numpy(framed).to(card)
    worst, shard_errs = (0, 0.0), None
    for mode in SP_MODES:
        net = None if mode == "webrtc" else load_net(rate, card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mono, _state = vad._vad_program(whole, window, rate, n, vad.initial_state(card),
                                        net, 0.0, mode)
        torch.cuda.synchronize()
        log("monolithic _vad_program %s, [%d, %d] as one chunk: %.4f s wall"
            % (mode, n, window, time.perf_counter() - t0))
        mono = mono.cpu().numpy().astype(np.float64)
        for mesh in meshes:
            det = vad_shard.make_sharded_detector(mesh, mode, SAMPLE_RATE, RATE, 0.0)
            shards, window_s, rate_s, n_s = det.stage(pcm)
            if [s.device for s in shards] != mesh:
                fail("shards staged on %r for the mesh %r" % ([s.device for s in shards], mesh))
            walls = []
            for sync_debug in ("default", "error"):
                torch.cuda.synchronize()
                fe.fused_frontend.launches = 0
                t0 = time.perf_counter()
                # "error": any host sync from the staged shards to the
                # joined labels raises
                torch.cuda.set_sync_debug_mode(sync_debug)
                try:
                    labels = det.run(shards, window_s, rate_s, n_s)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if fe.fused_frontend.launches != len(mesh) or labels.device != card:
                    fail("sharded %s: %d launches for %d shards, labels on %s"
                         % (mode, fe.fused_frontend.launches, len(mesh), labels.device))
            what = "%s on %s" % (mode, [str(d) for d in mesh])
            log("sharded %s: shards [%d, %d], run %.4f s, then %.4f s under "
                "sync-debug error (no host sync); %d launches per call"
                % (what, shards[0].shape[0], shards[0].shape[1], walls[0], walls[1], len(mesh)))
            flips, rest = _close_labels(labels.cpu().numpy().astype(np.float64), mono,
                                        "%s vs monolithic" % what)
            worst = (max(worst[0], flips), max(worst[1], rest))
            if shard_errs is None:
                x = shards[1]
                got = fe.fused_frontend(x, window_s, rate_s)
                torch.cuda.synchronize()
                shard_errs = compare(got, fe.frontend_plain(x, window_s, rate_s),
                                     "one shard [%d, %d] %s" % (
                                         x.shape[0], x.shape[1],
                                         str(x.dtype).replace("torch.", "")))
        del mono

    # the card's sharded labels against the port's on the CPU
    part = pcm[: LABEL_MINUTES * 60 * RATE]
    on_card = np.asarray(vad_shard.make_sharded_detector(
        meshes[0], "weighted", SAMPLE_RATE, RATE, 0.0)(part))
    on_cpu = np.asarray(vad_shard.make_sharded_detector(
        [torch.device("cpu")] * len(meshes[0]), "weighted", SAMPLE_RATE, RATE, 0.0)(part))
    _close_labels(on_card, on_cpu, "sharded weighted, %d min, card vs CPU" % LABEL_MINUTES)
    return launches, shard_errs, worst


def sp_gate_phase(workdir, wav_path, chunked_launches):
    """Phase 9, the product gate: a CLI sync with ``FFS_TPU_SP_VAD=1``. One
    card keeps the chunked path (``chunked_launches``, phase 4's fused
    count); two or more take one sharded call (one launch per card).
    Returns the launches."""
    import torch

    os.environ["FFS_TPU_SP_VAD"] = "1"
    try:
        with Instruments("fused_sp_env") as ins:
            result, wall = _timed_sync(workdir, wav_path, "fused")
    finally:
        del os.environ["FFS_TPU_SP_VAD"]
    n_cards = torch.cuda.device_count()
    want = (chunked_launches,) * 2 if n_cards < 2 else (n_cards, 0)
    log("fused sync with FFS_TPU_SP_VAD=1 on %d card(s): %.3f s wall, result %s, "
        "frontend launches %d, chunked programs %d"
        % (n_cards, wall, result, ins.launches, len(ins.programs)))
    _check_result("FFS_TPU_SP_VAD=1", result)
    if (ins.launches, len(ins.programs)) != want:
        fail("FFS_TPU_SP_VAD=1: %d launches and %d chunked programs, want %r"
             % (ins.launches, len(ins.programs), want))
    _on_card([ref for ref, _c, _o in ins.searches], "FFS_TPU_SP_VAD=1")
    return ins.launches


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


def _params_gap(got, want, lr_sum, tol, share, what):
    """Parameters (JAX layout): (the share within ``tol``, the largest
    difference, whether both bounds hold: ``tol`` on ``share`` of the
    entries and twice ``lr_sum`` on all)."""
    import numpy as np

    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    within, worst = float(np.mean(diffs <= tol)), float(diffs.max())
    log("  %s: %.6f of %d parameters within %g, max |d| %.3g (2 x summed lr %.3g)"
        % (what, within, len(diffs), tol, worst, 2 * lr_sum))
    return within, worst, (within >= share and worst <= 2 * lr_sum
                           and bool(np.isfinite(diffs).all()))


def _params_close(got, want, lr_sum, tol, share, what):
    """:func:`_params_gap`, failing outside the bounds. Returns (share
    within ``tol``, largest difference)."""
    within, worst, ok = _params_gap(got, want, lr_sum, tol, share, what)
    if not ok:
        fail("%s: parameters outside the bounds" % what)
    return within, worst


def _losses_gap(got, want, what):
    """The worst relative difference of two loss trajectories (inf where
    ``got`` is not finite)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    worst = float(np.max(np.abs(got - want) / np.abs(want)))
    log("  %s: losses %s against %s, worst relative difference %.3g"
        % (what, got.tolist(), want.tolist(), worst))
    return worst if np.isfinite(got).all() else float("inf")


def _losses_close(got, want, rel, what):
    worst = _losses_gap(got, want, what)
    if worst > rel:
        fail("%s: losses differ by %.3g relative (bound %g)" % (what, worst, rel))
    return worst


def train_phase(dev, pcm):
    """Phase 10. Returns a dict of what it measured."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.models import neural_vad as nv
    from ffsubsync_tpu_torch.models.synth_data import synth_batch
    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops import vad
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input
    from ffsubsync_tpu_torch.parallel.batch import adam, make_vad_train_step
    from ffsubsync_tpu_torch.scripts import train_neural_vad as tr

    out = {"errs": {}, "ms": {}, "plain_ms": {}, "host_ms": {}}
    # (a) the kernel against its plain version at each launch shape
    for rate, clips, seed in TRAIN_SHAPES:
        window = rate // SAMPLE_RATE
        pcm16, _labels = synth_batch(np.random.RandomState(seed), clips, TRAIN_CLIP_S,
                                     rate, SAMPLE_RATE)
        x = torch.from_numpy(pcm16.reshape(-1, window)).to(dev)
        got = fe.fused_frontend(x, window, rate)
        torch.cuda.synchronize()
        label = _shape(x)
        out["errs"][label] = compare(got, fe.frontend_plain(x, window, rate),
                                     "training features, %d clips of seed %d at %d Hz, %s"
                                     % (clips, seed, rate, label))
        out["ms"][label] = median_ms(lambda: fe.fused_frontend(x, window, rate),
                                     calls=KERNEL_CALLS)
        out["plain_ms"][label] = median_ms(lambda: fe.frontend_plain(x, window, rate),
                                           calls=KERNEL_CALLS)
        out["host_ms"][label] = host_ms(lambda: fe.fused_frontend(x, window, rate),
                                        calls=KERNEL_CALLS)
        log("  kernel at the trainer's launch shape %s: %.4f ms, plain %.4f ms; the host "
            "issues a kernel call in %.4f ms" % (label, out["ms"][label],
                                                 out["plain_ms"][label], out["host_ms"][label]))

    # (b) three steps of the script's optimizer, card against CPU
    args = tr.make_parser().parse_args(["--frame-rate", "12000", "--steps", str(TRAIN_LR_STEPS)])
    window = args.frame_rate // SAMPLE_RATE
    rng = np.random.RandomState(1)
    batches = [synth_batch(rng, args.batch, args.clip_seconds, args.frame_rate, SAMPLE_RATE,
                           return_weights=True) for _ in range(3)]
    init = nv.init_params(torch.Generator().manual_seed(0))
    runs = {}
    for where in ("cuda", "cpu"):
        net = nv.NeuralVADNet()
        net.load_state_dict(nv.params_from_numpy(init))
        net = net.to(where).train()
        optimizer = adam(net, 0.0)
        losses = [float(tr.train_step(net, optimizer, tr.schedule(args, i), *batch, window,
                                      SAMPLE_RATE)) for i, batch in enumerate(batches)]
        runs[where] = (losses, nv.params_to_numpy(net))
    lr_sum = sum(tr.schedule(args, i) for i in range(3))
    out["card_vs_cpu_loss_rel"] = _losses_close(runs["cuda"][0], runs["cpu"][0], TRAIN_LOSS_REL,
                                                "3 training steps, card vs CPU")
    out["card_vs_cpu_params"] = _params_close(runs["cuda"][1], runs["cpu"][1], lr_sum,
                                              TRAIN_PARAM_TOL, TRAIN_PARAM_SHARE,
                                              "3 training steps, card vs CPU")

    # (c) the trainer's entry, in-process, its launches counted from 0
    with tempfile.TemporaryDirectory(prefix="ffs_train_") as tmp:
        args = tr.make_parser().parse_args(["--frame-rate", "12000", "--steps", str(TRAIN_STEPS),
                                            "--out", os.path.join(tmp, "w.npz")])
        torch.cuda.synchronize()
        fe.fused_frontend.launches = 0
        t0 = time.perf_counter()
        result = tr.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fe.fused_frontend.launches
        with np.load(result.out) as f:
            written = {k: f[k] for k in f.files}
    log("trainer, %d steps of %d x %.0f s at %d Hz: %.3f s wall, held-out accuracy %.4f, "
        "frontend launches %d, losses first %.4f last %.4f"
        % (TRAIN_STEPS, args.batch, args.clip_seconds, args.frame_rate, wall, result.accuracy,
           launches, result.losses[0], result.losses[-1]))
    if launches != TRAIN_STEPS + 1:
        fail("trainer: %d frontend launches for %d steps and the held-out pass"
             % (launches, TRAIN_STEPS))
    if len(result.losses) != TRAIN_STEPS or not np.isfinite(result.losses).all():
        fail("trainer: losses %r" % (result.losses,))
    shapes = {k: v.shape for k, v in written.items()}
    if shapes != nv.expected_param_shapes() or any(v.dtype != np.float32 for v in written.values()):
        fail("trainer wrote %r" % ({k: (v.shape, v.dtype) for k, v in written.items()},))
    net = nv.NeuralVADNet()
    net.load_state_dict(nv.params_from_numpy(written))
    net = net.to(dev).eval()
    framed, rate, win, n = prepare_staged_input(pcm[: LABEL_MINUTES * 60 * RATE], RATE, SAMPLE_RATE)
    labels, _state = vad._vad_program(torch.from_numpy(framed).to(dev), win, rate, n,
                                      vad.initial_state(dev), net, 0.0, "silero")
    labels = labels[:n].cpu().numpy()
    if labels.shape != (LABEL_MINUTES * 60 * SAMPLE_RATE,) or not np.isfinite(labels).all():
        fail("trained weights: silero labels %r, finite %s"
             % (labels.shape, bool(np.isfinite(labels).all())))
    step_ms, synth_ms = float(np.median(result.step_ms)), float(np.median(result.synth_ms))
    log("trainer: %.4f card ms per step (median, CUDA events around features, forward, "
        "backward and optimizer), %.3f host ms of synth_batch per batch (median), host "
        "synthesis %.4f of the loop's wall; the trained net's silero labels over %d min: "
        "mean %.4f" % (step_ms, synth_ms, float(np.sum(result.synth_ms)) / 1e3 / result.wall_s,
                       LABEL_MINUTES, float(labels.mean())))
    out.update(launches=launches, wall=wall, step_ms=step_ms, synth_ms=synth_ms,
               accuracy=result.accuracy)

    # (d) the data-parallel step: [cuda:0, cuda:0] (and every card) against [cuda:0]
    pcm16, labels = batches[0][:2]
    ref = None
    for mesh in [[torch.device("cuda", 0)], [torch.device("cuda", 0)] * 2] + _distinct_cards():
        step_fn, init_fn = make_vad_train_step(mesh)
        net, optimizer, window = init_fn(torch.Generator().manual_seed(0), frame_rate=12000)
        net.load_state_dict(nv.params_from_numpy(init))
        loss = float(step_fn(net, optimizer, pcm16, labels, window))
        params = nv.params_to_numpy(net)
        if ref is None:
            ref = (loss, params)
            continue
        what = "make_vad_train_step over %s vs [cuda:0]" % [str(d) for d in mesh]
        _losses_close([loss], [ref[0]], MESH_LOSS_REL, what)
        _params_close(params, ref[1], 3e-3, MESH_PARAM_TOL, MESH_PARAM_SHARE, what)
    return out


def _first_input_vs_plain(ins, what):
    """The kernel against its plain version on the first staged input that
    a driven path gave ``_vad_program`` (on the card, as that path staged
    it). Returns the max abs error of each output."""
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe

    if ins.first_input is None:
        fail("%s: no VAD program ran" % what)
    x, window, rate = ins.first_input
    got = fe.fused_frontend(x, window, rate)
    torch.cuda.synchronize()
    return compare(got, fe.frontend_plain(x, window, rate),
                   "%s as staged, %s at %d Hz" % (what, _shape(x), rate))


def eval_phase():
    """Phase 11. Returns (launches of the card's adversarial eval, worst
    accuracy difference, the kernel's errors against its plain version at
    the eval's and the agreement harness's launch shapes, launches of the
    agreement harness)."""
    import torch

    from ffsubsync_tpu_torch.models import eval_data
    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.scripts import eval_neural_vad as ev
    from ffsubsync_tpu_torch.scripts import eval_vad_agreement as ag

    # the clips are made once and served to both runs
    real, made = eval_data.condition_clips, {}

    def cached(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items())))
        if key not in made:
            made[key] = real(*args, **kwargs)
        return made[key]

    eval_data.condition_clips = cached
    try:
        torch.cuda.synchronize()
        with Instruments("eval") as ins:
            t0 = time.perf_counter()
            card = ev.evaluate(EVAL_BACKENDS, 1, EVAL_SECONDS, EVAL_RATE, 0,
                               device=torch.device("cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ins.launches
        host = ev.evaluate(EVAL_BACKENDS, 1, EVAL_SECONDS, EVAL_RATE, 0, device=torch.device("cpu"))
    finally:
        eval_data.condition_clips = real
    errs = {"eval": _first_input_vs_plain(ins, "the eval's first condition clip")}
    n_cond = len(eval_data.CONDITIONS)
    log("adversarial eval, %d conditions x 1 clip of %.0f s at %d Hz, on the card (%.3f s wall "
        "with the clips' synthesis, frontend launches %d):\n%s\non the CPU:\n%s"
        % (n_cond, EVAL_SECONDS, EVAL_RATE, wall, launches,
           ev.render_table(card, EVAL_BACKENDS), ev.render_table(host, EVAL_BACKENDS)))
    if launches != n_cond * len(EVAL_BACKENDS):
        fail("eval: %d frontend launches for %d conditions x %d backends (one clip each)"
             % (launches, n_cond, len(EVAL_BACKENDS)))
    worst = max(abs(card[c][b] - host[c][b]) for c in card for b in EVAL_BACKENDS)
    log("adversarial eval card vs CPU: worst accuracy difference %.4f" % worst)
    if worst > EVAL_ACC_TOL:
        fail("eval: card and CPU accuracies differ by %.4f" % worst)
    with Instruments("agree") as ins:
        report = ag.run_synthetic(list(AGREE_VADS), AGREE_MINUTES, 12000, 0,
                                  scenarios=list(AGREE_SCENARIOS))
    violations = ag.check_bars(report, 12000)
    syncs = len(AGREE_VADS) * len(AGREE_SCENARIOS)
    log("agreement harness, %s on %s (%.0f min at 12 kHz): %s; bar violations %r; "
        "frontend launches %d for %d syncs, chunks dispatched %d"
        % (",".join(AGREE_VADS), ",".join(AGREE_SCENARIOS), AGREE_MINUTES,
           json.dumps(report["per_scenario"]), violations, ins.launches, syncs,
           len(ins.programs)))
    if violations or set(report["per_scenario"]) != set(AGREE_SCENARIOS):
        fail("agreement harness: %r" % (violations or report,))
    if ins.launches < syncs or ins.launches != len(ins.programs):
        fail("agreement harness: %d frontend launches for %d dispatched chunks of %d syncs"
             % (ins.launches, len(ins.programs), syncs))
    _on_card([ref for ref, _c, _o in ins.searches], "agreement harness")
    errs["agree"] = _first_input_vs_plain(ins, "the agreement harness's first movie")
    return launches, worst, errs, ins.launches


def pair_phase(dev, spans):
    """Phase 12. Returns a dict of what it measured."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops import align, align_device
    from ffsubsync_tpu_torch.ops import frontend as fe

    n_samples = MINUTES * 60 * SAMPLE_RATE
    ref = np.zeros(n_samples)
    for a, b in spans:
        ref[int(round(a * SAMPLE_RATE)):int(round(b * SAMPLE_RATE))] = 1.0
    sub = np.zeros(n_samples)  # sub[t] = ref[t + PAIR_SHIFT]
    sub[: n_samples - PAIR_SHIFT] = ref[PAIR_SHIFT:]
    n = align.next_pow2(2 * n_samples)
    ref_pm64, sub_pm64 = np.zeros(n), np.zeros(n)  # for an exact score
    ref_pm64[:n_samples], sub_pm64[:n_samples] = 2 * ref - 1, 2 * sub - 1
    devices, real = [], align_device.align_signals

    def recorded(ref_pm, *args):
        devices.append(ref_pm.device)
        return real(ref_pm, *args)

    out = {"n": n, "launches": 0, "card_ms": {}, "call_s": {}, "host_s": {}}
    saved = os.environ.get("FFS_TPU_HOST_ALIGN")
    try:
        for max_off in PAIR_MAX_OFFSETS:
            os.environ["FFS_TPU_HOST_ALIGN"] = "1"
            t0 = time.perf_counter()
            host = align.align_signal_pair(ref, sub, max_off)
            host_s = time.perf_counter() - t0
            del os.environ["FFS_TPU_HOST_ALIGN"]  # the default: the card
            align_device.align_signals = recorded
            del devices[:]
            fe.fused_frontend.launches = 0
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card = align.align_signal_pair(ref, sub, max_off)
                torch.cuda.synchronize()
                call_s = time.perf_counter() - t0
            finally:
                align_device.align_signals = real
            out["launches"] += fe.fused_frontend.launches
            what = "align_signal_pair of %d samples, max_offset_samples %s" % (n_samples, max_off)
            if [d.type for d in devices] != [dev.type]:
                fail("%s: the search ran on %r, not once on the card" % (what, devices))
            if host.offset != PAIR_SHIFT:
                fail("%s: the host branch found %d, the shift is %d" % (what, host.offset, PAIR_SHIFT))
            rel = abs(card.score - host.score) / abs(host.score)
            tie = ""
            if card.offset != host.offset:
                # C4: among offsets whose scores tie exactly, float32 FFT
                # rounding decides the card's pick
                exact = float(np.dot(sub_pm64, np.roll(ref_pm64, -card.offset)))
                if exact != host.score:
                    fail("%s: card offset %d (exact score %r), host %d (score %r)"
                         % (what, card.offset, exact, host.offset, host.score))
                tie = " (an exact tie with the host's %d)" % host.offset
            if rel > PAIR_SCORE_REL or not np.isfinite(card.score):
                fail("%s: card score %r, host %r" % (what, card.score, host.score))
            # the search alone on resident inputs (CUDA events)
            ref_pm = align.prepare_ref_pm(ref.astype(np.float32), n, dev)
            sub_pm = align.prepare_ref_pm(sub.astype(np.float32), n, dev)[None]
            hi, cnt, n_offsets = align.search_window(n, n_samples, max_off)
            bounds = (torch.tensor([hi], device=dev), torch.tensor([cnt], device=dev))
            ms = median_ms(lambda: real(ref_pm, sub_pm, *bounds, n, n_offsets), n=10, warm=2,
                           calls=3)
            label = "max%s" % max_off
            out["card_ms"][label], out["call_s"][label], out["host_s"][label] = ms, call_s, host_s
            log("pair %s: host offset %d score %.1f (%.4f s); card offset %d%s score %.1f, "
                "relative score difference %.3g; card search %.4f ms (align_signals on resident "
                "[%d] inputs, CUDA events, median of 10 samples of 3 calls); the whole device-branch "
                "call %.4f s with its host-to-card copies"
                % (what, host.offset, host.score, host_s, card.offset, tie, card.score, rel, ms, n,
                   call_s))
    finally:
        os.environ.pop("FFS_TPU_HOST_ALIGN", None)
        if saved is not None:
            os.environ["FFS_TPU_HOST_ALIGN"] = saved
    if out["launches"]:
        fail("raw-signal alignment launched the frontend kernel %d times" % out["launches"])
    return out


def _artifact(name):
    with open(os.path.join(HERE, name)) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def babble_phase(dev):
    """Phase 13, the babble-ceiling probe. Returns a dict of what it
    measured."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.models import neural_vad as nv
    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops.features import log_mel_features
    from ffsubsync_tpu_torch.parallel import batch
    from ffsubsync_tpu_torch.scripts import probe_babble_ceiling as babble

    args = babble.make_parser().parse_args(["--steps", str(BABBLE_STEPS)])
    window = args.frame_rate // args.sample_rate
    # the feature passes of the training step (parallel.batch) and of the
    # scoring (the probe's own), each input's first of its shape kept
    first, real = {}, log_mel_features

    def recorded(pcm16, *a, **k):
        first.setdefault(tuple(np.shape(pcm16)), pcm16)
        return real(pcm16, *a, **k)

    batch.log_mel_features = babble.log_mel_features = recorded
    try:
        torch.cuda.synchronize()
        fe.fused_frontend.launches = 0
        t0 = time.perf_counter()
        run = babble.train(args, dev)
        report = babble.score(run.net, args, dev, n_clips=BABBLE_SCORE_CLIPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fe.fused_frontend.launches
    finally:
        batch.log_mel_features = babble.log_mel_features = real
    # a step's features, then per scoring clip the probe's and the shipped
    # detector's
    want = BABBLE_STEPS + 2 * BABBLE_SCORE_CLIPS * len(babble.CONDITIONS)
    log("babble probe, %d steps of %d x %.0f s at %d Hz and %d clips of 30 s per condition: "
        "%.3f s wall, frontend launches %d, losses %s, report %s"
        % (BABBLE_STEPS, args.batch, args.clip_seconds, args.frame_rate, BABBLE_SCORE_CLIPS,
           wall, launches, ["%.4f" % x for x in run.losses], json.dumps(report)))
    if launches != want:
        fail("babble probe: %d frontend launches, want %d" % (launches, want))
    values = [v for row in report.values() for v in row.values()]
    if (sorted(report) != sorted(babble.CONDITIONS) or not np.isfinite(run.losses).all()
            or not all(0.0 <= v <= 1.0 for v in values)):
        fail("babble probe: losses %r, report %r" % (run.losses, report))
    out = {"errs": {}, "ms": {}, "plain_ms": {}, "bound_ms": {}, "host_ms": {},
           "launches": launches, "wall": wall, "report": report}
    if len(first) != 2:
        fail("babble probe: feature inputs of shapes %r" % sorted(first))
    for shape, pcm16 in first.items():
        x = torch.from_numpy(np.ascontiguousarray(pcm16).reshape(-1, window)).to(dev)
        got = fe.fused_frontend(x, window, args.frame_rate)
        torch.cuda.synchronize()
        label = _shape(x)
        out["errs"][label] = compare(got, fe.frontend_plain(x, window, args.frame_rate),
                                     "babble probe's first %d-clip features %s" % (shape[0], label))
        out["ms"][label] = median_ms(lambda: fe.fused_frontend(x, window, args.frame_rate),
                                     calls=KERNEL_CALLS)
        out["plain_ms"][label] = median_ms(lambda: fe.frontend_plain(x, window, args.frame_rate),
                                           calls=KERNEL_CALLS)
        cfg = fe.kernel_config(window, fe.wire_kind(x, window))
        bounds = frontend_bounds(x.shape[0], window, args.frame_rate,
                                 x.shape[1] * x.element_size(), cfg.n_cols)
        out["bound_ms"][label] = max(bounds["ops_ms"], bounds["bytes_ms"])
        out["host_ms"][label] = host_ms(lambda: fe.fused_frontend(x, window, args.frame_rate),
                                        calls=KERNEL_CALLS)
        log("  kernel at the babble probe's launch shape %s: %.4f ms, plain %.4f ms; bound "
            "%.4f ms (operations %.4f, bytes %.4f); the host issues a kernel call in %.4f ms"
            % (label, out["ms"][label], out["plain_ms"][label], out["bound_ms"][label],
               bounds["ops_ms"], bounds["bytes_ms"], out["host_ms"][label]))
    # the same steps on the CPU
    host = babble.train(args, torch.device("cpu"))
    lr_sum = sum(babble.schedule(args, i) for i in range(BABBLE_STEPS))
    what = "%d babble-probe steps, card vs CPU" % BABBLE_STEPS
    out["card_vs_cpu_loss_rel"] = _losses_close(run.losses, host.losses, BABBLE_LOSS_REL, what)
    out["card_vs_cpu_params"] = _params_close(nv.params_to_numpy(run.net),
                                              nv.params_to_numpy(host.net), lr_sum,
                                              TRAIN_PARAM_TOL, BABBLE_PARAM_SHARE, what)
    # a planted fault: the same steps on the card with one update taken the
    # wrong way (Adam's update is odd in its rate), which both checks must
    # reject
    schedule = babble.schedule
    babble.schedule = lambda a, i: (-1 if i == BABBLE_FAULT_STEP else 1) * schedule(a, i)
    try:
        fault = babble.train(args, dev)
    finally:
        babble.schedule = schedule
    what = "%d babble-probe steps with step %d's update reversed, card vs CPU" % (
        BABBLE_STEPS, BABBLE_FAULT_STEP)
    loss_rel = _losses_gap(fault.losses, host.losses, what)
    within, worst, params_pass = _params_gap(
        nv.params_to_numpy(fault.net), nv.params_to_numpy(host.net), lr_sum, TRAIN_PARAM_TOL,
        BABBLE_PARAM_SHARE, what)
    out["fault_loss_rel"], out["fault_params"] = loss_rel, (within, worst)
    if loss_rel <= BABBLE_LOSS_REL or params_pass:
        fail("%s: the checks pass it (losses %.3g relative, bound %g; parameters %s)"
             % (what, loss_rel, BABBLE_LOSS_REL, "pass" if params_pass else "fail"))
    return out


def jitter_phase():
    """Phase 13, the noisy-jitter probe in-process. Returns (launches, its
    row, the kernel's errors against its plain version on the first staged
    movie)."""
    from ffsubsync_tpu_torch.scripts import probe_noisy_jitter as jitter

    with Instruments("jitter") as ins:
        report = jitter.sweep(list(JITTER_VADS), [JITTER_SEED], [JITTER_MINUTES], 12000)
    (row,) = report["sweep"]
    (want,) = [r for r in _artifact("EVAL_noisy_jitter.json")["sweep"]
               if r["seed"] == JITTER_SEED and r["minutes"] == JITTER_MINUTES]
    log("noisy-jitter probe, seed %d, %.0f min: cells %s; EVAL_noisy_jitter.json's row %s; "
        "frontend launches %d for %d syncs, chunks dispatched %d"
        % (JITTER_SEED, JITTER_MINUTES, json.dumps(row["cells"]), json.dumps(want["cells"]),
           ins.launches, len(JITTER_VADS), len(ins.programs)))
    for vad, cell in want["cells"].items():
        if cell is not None and not isinstance(row["cells"].get(vad), int):
            fail("noisy-jitter probe: %s gave %r where the artifact has %r"
                 % (vad, row["cells"].get(vad), cell))
    if ins.launches < len(JITTER_VADS) or ins.launches != len(ins.programs):
        fail("noisy-jitter probe: %d frontend launches for %d dispatched chunks"
             % (ins.launches, len(ins.programs)))
    _on_card([ref for ref, _c, _o in ins.searches], "noisy-jitter probe")
    return ins.launches, row, _first_input_vs_plain(ins, "the jitter probe's movie")


def bias_phase():
    """Phase 13, the webrtc-bias probe in a process of its own on the card.
    Returns (launches, its errors per scenario)."""
    import math

    cmd = [sys.executable, "-m", "ffsubsync_tpu_torch.scripts.probe_webrtc_bias",
           "--seeds", str(BIAS_SEED), "--minutes", "%g" % BIAS_MINUTES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail("webrtc-bias probe exited %d:\n%s" % (proc.returncode, proc.stderr[-3000:]))
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = [int(n) for n in re.findall(r"^frontend kernel launches: (\d+)$", proc.stderr, re.M)]
    errs = report["by_minutes"]["%g" % BIAS_MINUTES]["per_seed"][str(BIAS_SEED)]
    want = _artifact("EVAL_webrtc_bias.json")["by_minutes"]["%g" % BIAS_MINUTES]["per_seed"][
        str(BIAS_SEED)]
    log("webrtc-bias probe, seed %d, %.0f min (%.3f s wall, a process of its own): errors %s s; "
        "EVAL_webrtc_bias.json's row %s s; frontend launches %s"
        % (BIAS_SEED, BIAS_MINUTES, wall, json.dumps(errs), json.dumps(want), launches))
    for name, err in want.items():
        if err is not None and not (isinstance(errs.get(name), float)
                                    and math.isfinite(errs[name])):
            fail("webrtc-bias probe: %s gave %r where the artifact has %r"
                 % (name, errs.get(name), err))
    if len(launches) != 1 or launches[0] < len(want):
        fail("webrtc-bias probe: frontend launches %r for %d syncs" % (launches, len(want)))
    return launches[0], errs, wall


def _bench_schema(script):
    """The keys the port's ``script`` must print: those of the reference's
    recorded line (``BENCH_*_r05.json``), ``platform`` where it had none,
    and ``device``."""
    with open(os.path.join(HERE, BENCH_ARTIFACTS[script])) as f:
        line = json.load(f)
    line = line.get("parsed", line)
    return set(line) | {"platform", "device"}, line


def _finite_times(line, what):
    """Every wall time of a bench line (``value`` and each ``*_s``, nested
    ones too) must be a finite number."""
    import math

    for key, value in line.items():
        if isinstance(value, dict):
            _finite_times(value, "%s %s" % (what, key))
        elif key == "value" or key.endswith("_s"):
            if not (isinstance(value, (int, float)) and math.isfinite(value)):
                fail("%s: %s is %r" % (what, key, value))


def bench_script(script, knobs, want_launches, smi):
    """Phase 14, one benchmark script as a user runs it, in a process of
    its own on the card. Returns (launches, its JSON line, wall s)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs)
    cmd = [sys.executable, "-m", "ffsubsync_tpu_torch.scripts." + script]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE, env=env, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        fail("%s exited %d:\n%s" % (script, proc.returncode, proc.stderr[-3000:]))
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log("%s (%s; %.1f s, a process of its own): %s"
        % (script, " ".join("%s=%s" % kv for kv in knobs.items()), wall, json.dumps(line)))
    keys, reference = _bench_schema(script)
    if set(line) != keys:
        fail("%s: keys %s, want %s" % (script, sorted(line), sorted(keys)))
    for case in ("breakdown", "srt_srt", "wav5_energy", "multiseg"):
        if case in reference and set(line[case] or ()) != set(reference[case]):
            fail("%s: %s keys %r, want %s" % (script, case, line[case], sorted(reference[case])))
    if line["platform"] != "cuda" or line["device"] != smi:
        fail("%s: platform %r on %r, want cuda on %r"
             % (script, line["platform"], line["device"], smi))
    _finite_times(line, script)
    launches = [int(n) for n in re.findall(r"^frontend kernel launches: (\d+)$", proc.stderr, re.M)]
    if launches != [want_launches]:
        fail("%s: frontend launches %r, the knobs imply %d" % (script, launches, want_launches))
    return launches[0], line, wall


def wav5_plateau(err_ms):
    """bench_suite's wav5_energy case rebuilt here from its ``RandomState(0)``
    draws (srt_srt's come first) and synced once in-process on the card.
    auditok's hard labels leave exact-tie plateaus in the search, whose pick
    float32 FFT rounding decides (ROADMAP C4). Returns (the plateau of
    offsets scoring exactly what the truth scores, in seconds, and whether
    the script's pick, ``err_ms`` from the truth, lies on it)."""
    import numpy as np

    from ffsubsync_tpu_torch.scripts import bench_suite as suite

    truth = int(round(suite.TRUE_OFFSET * SAMPLE_RATE))
    rng = np.random.RandomState(0)
    suite._spans(rng, 45 * 60.0)
    with tempfile.TemporaryDirectory(prefix="ffs_wav5_") as tmp, Instruments() as ins:
        suite.wav5_energy(rng, tmp, 1)
    spec, alignment = _pick(ins.searches[0])
    labels = np.asarray(ins.searches[0][0])
    # sync's first candidate is the ratio 1.0, whose offsets are the truth's
    if ins.launches != 1 or spec is not ins.searches[0][1][0]:
        fail("wav5_energy in-process: %d launches, or a candidate other than ratio 1.0 won"
             % ins.launches)
    scores = {off: _exact_score(labels, spec, off) for off in range(truth - 100, truth + 101)}

    def tied(off):
        return scores.get(off) == scores[truth]

    lo = hi = truth
    while tied(lo - 1):
        lo -= 1
    while tied(hi + 1):
        hi += 1
    shift = None if err_ms is None else int(round(err_ms * SAMPLE_RATE / 1000.0))
    on_it = shift is not None and (lo <= truth + shift <= hi or lo <= truth - shift <= hi)
    log("  wav5_energy rebuilt in-process: pick %.2f s (exact score %.1f), the truth %.2f s "
        "(%.1f), its exact-tie plateau %.2f-%.2f s; the script's pick (%r ms off) on it: %s"
        % (alignment.offset / SAMPLE_RATE, scores.get(alignment.offset, float("nan")),
           truth / SAMPLE_RATE, scores[truth], lo / SAMPLE_RATE, hi / SAMPLE_RATE, err_ms, on_it))
    return (lo / SAMPLE_RATE, hi / SAMPLE_RATE), on_it


def bench_phase(dev, pcm, smi):
    """Phase 14. Returns a dict of what it measured."""
    import torch

    torch.cuda.empty_cache()  # the scripts' processes share the card
    out = {"launches": {}, "lines": {}, "walls": {}}
    for script, knobs, want in BENCH_SCRIPTS:
        out["launches"][script], line, out["walls"][script] = bench_script(
            script, knobs, want, smi)
        out["lines"][script] = line
    bench, batch, suite = (out["lines"][s] for s, _k, _w in BENCH_SCRIPTS)
    for key in ("offset_err_ms", "e2e_offset_err_ms"):
        if bench[key] is None or bench[key] > BENCH_OFFSET_MS:
            fail("bench: %s %r, bound %g ms" % (key, bench[key], BENCH_OFFSET_MS))
    if batch["offsets_exact"] is not True:
        fail("bench_batch: offsets not exact")
    reference = _bench_schema("bench_suite")[1]
    out["wav5_plateau"], tied = wav5_plateau(suite["wav5_energy"]["offset_err_ms"])
    for case in ("srt_srt", "wav5_energy", "multiseg"):
        err = suite[case]["offset_err_ms"]
        log("  bench_suite %s: offset error %r ms; BENCH_SUITE_r05.json's %r ms"
            % (case, err, reference[case]["offset_err_ms"]))
        # beyond the bar, wav5_energy's pick passes only as an exact tie
        # with the truth
        if err is None or (err > SUITE_OFFSET_MS and not (case == "wav5_energy" and tied)):
            fail("bench_suite %s: offset error %r ms, bound %g ms" % (case, err, SUITE_OFFSET_MS))
    # the suite's one new launch shape: wav5_energy's auditok detector
    # stages the whole 5-minute 12 kHz signal
    out.update(kernel_at(_staged(pcm, WAV5_WINDOWS), "bench_suite wav5_energy"))
    return out


def kernel_at(x, what):
    """The kernel at one more path's launch shape, ``x`` staged at 12 kHz
    on the card: held against its plain version under ``TOLS``, timed
    beside it (CUDA events), its bound, and the host's issue time of a
    kernel call. Returns a dict of what it measured."""
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe

    window = RATE // SAMPLE_RATE
    got = fe.fused_frontend(x, window, RATE)
    torch.cuda.synchronize()
    label = _shape(x)
    out = {"shape": label,
           "errs": compare(got, fe.frontend_plain(x, window, RATE), "%s %s" % (what, label))}
    out["ms"] = median_ms(lambda: fe.fused_frontend(x, window, RATE), calls=KERNEL_CALLS)
    out["plain_ms"] = median_ms(lambda: fe.frontend_plain(x, window, RATE), calls=KERNEL_CALLS)
    out["host_ms"] = host_ms(lambda: fe.fused_frontend(x, window, RATE), calls=KERNEL_CALLS)
    cfg = fe.kernel_config(window, fe.wire_kind(x, window))
    bounds = frontend_bounds(x.shape[0], window, RATE, x.shape[1] * x.element_size(), cfg.n_cols)
    out["bound_ms"] = max(bounds["ops_ms"], bounds["bytes_ms"])
    log("  kernel at %s's launch shape %s: %.4f ms, plain %.4f ms; bound %.4f ms (operations "
        "%.4f, bytes %.4f); the host issues a kernel call in %.4f ms"
        % (what, label, out["ms"], out["plain_ms"], out["bound_ms"], bounds["ops_ms"],
           bounds["bytes_ms"], out["host_ms"]))
    return out


# phase 15: the lines of each diagnostic, as the JAX scripts print them
# (label: pattern); a timed line names its best time and its list of times
_TIMES = r"best (?P<best>\S+) s  all \[(?P<all>.*)\]"
DIAG_LINES = {
    "diag_breakdown": {
        "device": r"device: cuda (.+) \| analysis rate (\d+)",
        "problem": r"(\d+) spans, (\d+) samples \((\S+) MB i16\)",
        "chunks": r"(\d+) pipeline chunks of (\d+) samples",
        "stage_host": r"stage_host   " + _TIMES,
        "wire": r"wire bytes: (\S+) MB",
        "xfer": r"xfer         " + _TIMES + r"  \((\d+) MB/s best\)",
        **{"vad[%s]" % mode: r"vad\[%s\] pipeline \(stage\+xfer\+compute\) " % mode + _TIMES
           for mode in ("webrtc", "silero", "fused")},
        "align": r"align        " + _TIMES,
        "pull": r"pull         " + _TIMES,
    },
    "diag_chunks": {
        "device": r"device: cuda (.+)",
        **{"sweep %s" % seconds: r"pipeline_seconds=%s \((\d+) launches\): warm (\S+) s, "
           r"best (?P<best>\S+) s, all \[(?P<all>.*)\]" % seconds
           for seconds in DIAG_SWEEP_CHUNKS},
    },
}


def _parse_diag(script, err, smi):
    """Each line ``DIAG_LINES`` names, found once in ``err``: returns
    {label: its match}. A timed line must hold ``DIAG_RUNS`` finite times
    and a finite best; the device line must name ``smi``'s card."""
    import math

    found = {}
    for label, pattern in DIAG_LINES[script].items():
        hits = [m for m in map(re.compile(pattern).fullmatch, err.splitlines()) if m]
        if len(hits) != 1:
            fail("%s: %d lines of %r in:\n%s" % (script, len(hits), label, err[-3000:]))
        found[label] = match = hits[0]
        if "all" in match.groupdict():
            times = [float(t) for t in match["all"].split(",") if t.strip()]
            times.append(float(match["best"]))
            if len(times) != DIAG_RUNS + 1 or not all(map(math.isfinite, times)):
                fail("%s: %r, want %d finite times" % (script, match.group(0), DIAG_RUNS))
    if found["device"][1] != smi:
        fail("%s: device line %r, want %r" % (script, found["device"].group(0), smi))
    return found


def diag_script(script, smi):
    """Phase 15, one diagnostic started as a user runs it (``python -m
    ffsubsync_tpu_torch.scripts.<script> 90 DIAG_RUNS``), on the card with
    the default pipeline chunk. Returns a function that waits for it and
    returns (its parsed lines, launches, wall s)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("FFS_TORCH_DEVICE", "FFS_TPU_PIPELINE_SECONDS")}
    cmd = [sys.executable, "-m", "ffsubsync_tpu_torch.scripts." + script, str(MINUTES),
           str(DIAG_RUNS)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)

    def wait():
        try:
            _out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        wall = time.perf_counter() - t0
        if proc.returncode:
            fail("%s exited %d:\n%s" % (script, proc.returncode, err[-3000:]))
        log("%s %d %d (%.1f s, a process of its own):\n  %s"
            % (script, MINUTES, DIAG_RUNS, wall, "\n  ".join(err.strip().splitlines())))
        launches = [int(n) for n in re.findall(r"^frontend kernel launches: (\d+)$", err, re.M)]
        if launches != [DIAG_LAUNCHES[script]]:
            fail("%s: frontend launches %r, the knobs imply %d"
                 % (script, launches, DIAG_LAUNCHES[script]))
        return _parse_diag(script, err, smi), launches[0], wall

    return wait


def profiled_sync(workdir, wav_path):
    """Phase 15, ``--profile-dir``: phase 4's fused sync through the CLI
    entry with a ``torch.profiler`` trace. The shift must be recovered and
    ``trace.json`` must hold CUDA kernel events, the frontend kernel's
    among them, one per launch. Returns a dict of what it found."""
    import torch

    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.cli import make_parser

    prof_dir = os.path.join(workdir, "profile")
    argv = _sync_argv(workdir, wav_path, "fused") + ["--profile-dir", prof_dir]
    with Instruments("profile") as ins:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = sync.run(make_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _check_result("profiled fused", result)
    path = os.path.join(prof_dir, "trace.json")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    frontend = [e for e in kernels if "frontend_kernel" in e.get("name", "")]
    names = sorted({e["name"] for e in frontend})
    # the scan kernel: scan_tiles (one or two per call) and scan_totals
    scans = [e for e in kernels if "scan_t" in e.get("name", "")]
    out = {"launches": ins.launches, "wall": wall, "trace_mb": os.path.getsize(path) / 1e6,
           "kernel_events": len(kernels), "frontend_events": len(frontend),
           "frontend_us": [e.get("dur") for e in frontend], "names": names,
           "offset_s": result["offset_seconds"], "scan_launches": ins.scan_launches,
           "scan_events": len(scans), "scan_us": sum(e.get("dur", 0) for e in scans)}
    log("profiled fused sync (--profile-dir): %.3f s wall, offset %.3f s, frontend launches %d; "
        "trace.json %.1f MB, %d events, %d CUDA kernel events, %d of the frontend kernel %s "
        "(card us each: %s)"
        % (wall, result["offset_seconds"], ins.launches, out["trace_mb"], len(events),
           len(kernels), len(frontend), names, out["frontend_us"]))
    if not kernels:
        fail("--profile-dir: trace.json holds no CUDA kernel event")
    if len(frontend) != ins.launches or ins.launches == 0:
        fail("--profile-dir: %d frontend kernel events for %d launches"
             % (len(frontend), ins.launches))
    log("  the scan kernel in the trace: %d events (%d scan calls), %.1f card us in all"
        % (len(scans), ins.scan_launches, out["scan_us"]))
    if ins.scan_launches == 0 or len(scans) < ins.scan_launches:
        fail("--profile-dir: %d scan kernel events for %d scan calls"
             % (len(scans), ins.scan_launches))
    return out


def diag_phase(dev, workdir, wav_path, smi):
    """Phase 15. Returns a dict of what it measured."""
    import torch

    from ffsubsync_tpu_torch.ops.vad import make_detector
    from ffsubsync_tpu_torch.scripts import diag_breakdown as diag
    from ffsubsync_tpu_torch.scripts.bench import make_problem

    torch.cuda.empty_cache()  # the scripts' processes share the card
    out = {"launches": {}, "lines": {}, "walls": {}}
    # the problem both scripts make, made here while diag_breakdown makes
    # its own; the card stays theirs while they time it, one at a time
    wait = diag_script("diag_breakdown", smi)
    pcm, _spans, _sub, candidates, _ratios = make_problem(MINUTES, RATE)
    done = {"diag_breakdown": wait(), "diag_chunks": diag_script("diag_chunks", smi)()}
    for script, (lines, launches, wall) in done.items():
        out["lines"][script], out["launches"][script], out["walls"][script] = lines, launches, wall
    lines = out["lines"]["diag_breakdown"]
    chunks = diag.pipeline_chunks(pcm, RATE)
    wire = "%.1f" % (sum(f.nbytes for f, _r, _w, _n in diag.stage_host(chunks, RATE)) / 1e6)
    if (lines["wire"][1] != wire or lines["problem"][2] != str(len(pcm))
            or lines["chunks"].groups() != (str(len(chunks)), str(len(chunks[0])))):
        fail("diag_breakdown: %r, %r and %r, staged here %s MB in %d chunks of %d samples of %d"
             % (lines["wire"].group(0), lines["chunks"].group(0), lines["problem"].group(0), wire,
                len(chunks), len(chunks[0]), len(pcm)))
    sweep = out["lines"]["diag_chunks"]
    got = {s: int(sweep["sweep %s" % s][1]) for s in DIAG_SWEEP_CHUNKS}
    if got != DIAG_SWEEP_CHUNKS:
        fail("diag_chunks: launches per setting %r, want %r" % (got, DIAG_SWEEP_CHUNKS))
    # what the scripts leave out of their windows and bench's stage_s holds:
    # building a fused detector (the net's weights onto the card)
    builds = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = make_detector("fused", SAMPLE_RATE, RATE, 0.0, dev)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    out["detector_build_s"] = sorted(builds)[len(builds) // 2]
    log("fused detector build (the net's weights onto the card): median %.4f s of 5, all %s"
        % (out["detector_build_s"], ["%.4f" % b for b in builds]))
    # the search's pick, which the script does not check: its align stage
    # rerun here on the same problem
    signal = diag.vad(det, pcm, dev)
    _on_card([signal], "diag_breakdown's align stage")
    results = diag.align(signal, candidates)
    best = max(range(len(results)), key=lambda i: results[i].score)
    out["offset_s"] = results[best].offset / SAMPLE_RATE
    log("diag_breakdown's align stage in-process: candidate %d, offset %.2f s (truth %.2f), "
        "score %.1f; wire bytes %s MB staged here" % (best, out["offset_s"], TRUE_OFFSET_S,
                                                       results[best].score, wire))
    if best != 0 or abs(out["offset_s"] - TRUE_OFFSET_S) > 0.15:
        fail("diag_breakdown's align stage: candidate %d at %.3f s, truth ratio 1.0 at %.3f s"
             % (best, out["offset_s"], TRUE_OFFSET_S))
    # diag_chunks' one new launch shape: its 600-s chunk of the problem
    out.update(kernel_at(_staged(pcm, CHUNKS600_WINDOWS), "diag_chunks' 600-s chunk"))
    del pcm, signal, det
    out["profile"] = profiled_sync(workdir, wav_path)
    return out


def _check_scans(what, got, programs):
    """The scan kernel's launches on a driven path: SCANS_PER_PROGRAM per
    detector program (a chunk, segment, job or shard)."""
    if got != SCANS_PER_PROGRAM * programs:
        fail("%s: %d scan kernel launches for %d detector programs (want %d each)"
             % (what, got, programs, SCANS_PER_PROGRAM))


class ScanCalls:
    """Within the block every scan of the detectors takes the kernel (or,
    with ``plain``, its plain version) and, with ``record``, is kept in
    ``calls`` as (key, inputs, reverse)."""

    def __init__(self, plain=False, record=True):
        self.plain, self.record = plain, record

    def __enter__(self):
        from ffsubsync_tpu_torch.ops import scan

        self.calls = []
        self._real = (scan.scan_cols, scan.affine_scan)
        cols = scan.scan_cols_plain if self.plain else scan.scan_cols
        affine = scan.affine_scan_plain if self.plain else scan.affine_scan

        def scan_cols(x, op, reverse=False):
            if self.record:
                self.calls.append((op + ("_reverse" if reverse else ""), (x,), reverse))
            return cols(x, op, reverse)

        def affine_scan(a, b):
            if self.record:
                self.calls.append(("affine", (a, b), False))
            return affine(a, b)

        scan.scan_cols, scan.affine_scan = scan_cols, affine_scan
        return self

    def __exit__(self, *exc):
        from ffsubsync_tpu_torch.ops import scan

        scan.scan_cols, scan.affine_scan = self._real
        return False


def _run_scan(call, plain):
    """One recorded scan again, by the kernel or its plain version; a tuple
    of outputs."""
    from ffsubsync_tpu_torch.ops import scan

    key, xs, reverse = call
    if key == "affine":
        return (scan.affine_scan_plain if plain else scan.affine_scan)(*xs)
    cols = scan.scan_cols_plain if plain else scan.scan_cols
    return (cols(xs[0], key.split("_")[0], reverse),)


def scan_bounds(calls):
    """The least time the card could take for the recorded scans, in ms:
    each input read once and each output written once at 3.35 TB/s, and one
    operation per element (three per affine pair) at the float32 peak."""
    nbytes = sum(2 * x.numel() * x.element_size() for _key, xs, _rev in calls for x in xs)
    ops = sum(xs[0].numel() * (3 if key == "affine" else 1) for key, xs, _rev in calls)
    return {"bytes_ms": nbytes / PEAK_BYTES * 1e3, "ops_ms": ops / PEAK_F32 * 1e3,
            "mbytes": nbytes / 1e6}


def _exact_scan(call):
    """One recorded scan in float64 on the card: the yardstick of the
    float32 sums and affine pairs."""
    import torch

    from ffsubsync_tpu_torch.ops import scan

    key, xs, _reverse = call
    if key == "affine":
        return scan.affine_scan_plain(*(x.double() for x in xs))
    return (torch.cumsum(xs[0].double(), dim=0),)


def _scan_errors(calls, what):
    """Every recorded scan, kernel against plain on its inputs. min and max
    must be equal. add and the affine pair, both float32, must lie within
    SCAN_RTOL of the largest |plain|, and the kernel no farther from the
    float64 scan than the plain version is (or than 1e-6 of the largest
    |plain|). Returns (largest |kernel - plain|, the same relative to its
    output's max |plain|, and the largest distance from float64 relative
    to max |plain| of the kernel and of the plain version)."""
    import torch

    worst = {"abs": 0.0, "rel": 0.0, "kernel_f64": 0.0, "plain_f64": 0.0}
    for call in calls:
        got, want = _run_scan(call, False), _run_scan(call, True)
        exact = _exact_scan(call) if call[0] in ("add", "affine") else want
        for g, w, e in zip(got, want, exact):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail("%s, %s: kernel %s %r, plain %s %r" % (what, call[0], g.dtype,
                                                           tuple(g.shape), w.dtype, tuple(w.shape)))
            scale = max(float(w.double().abs().max()), 1e-30)
            err = float((g.double() - w.double()).abs().max())
            kern_f64 = float((g.double() - e.double()).abs().max()) / scale
            plain_f64 = float((w.double() - e.double()).abs().max()) / scale
            for key, value in (("abs", err), ("rel", err / scale), ("kernel_f64", kern_f64),
                               ("plain_f64", plain_f64)):
                worst[key] = max(worst[key], value)
            if call[0] not in ("add", "affine"):
                bad = not torch.equal(g, w)
            else:
                bad = err / scale > SCAN_RTOL or kern_f64 > max(plain_f64, 1e-6)
            if bad:
                fail("%s, %s scan of %r: max |kernel - plain| %.4g (%.3g of max |plain|); "
                     "from float64 the kernel %.3g, plain %.3g of max |plain|"
                     % (what, call[0], tuple(g.shape), err, err / scale, kern_f64, plain_f64))
    return worst


def _scan_path(label, run, programs):
    """Phase 16 at one path's shapes. ``run()`` drives the path's detector
    program(s) on the card and returns (webrtc labels, carried state or
    None); it runs once by the kernel, with its scans recorded, and once by
    the plain version. Returns a dict of what was measured."""
    import numpy as np
    import torch

    with ScanCalls() as kern:
        got, got_state = run()
    with ScanCalls(plain=True, record=False):
        want, want_state = run()
    torch.cuda.synchronize()
    calls = kern.calls
    if len(calls) != SCANS_PER_PROGRAM * programs:
        fail("%s: %d scans for %d detector programs" % (label, len(calls), programs))
    flips, rest = _close_labels(got.cpu().numpy().astype(np.float64),
                                want.cpu().numpy().astype(np.float64),
                                "%s, webrtc labels by the scan kernel vs plain" % label)
    state_rel = 0.0
    for name in (got_state or {}):
        g, w = got_state[name], want_state[name]
        if not isinstance(g, torch.Tensor):
            if g != w:
                fail("%s: carried %s %r by the kernel, %r by plain" % (label, name, g, w))
            continue
        g, w = g.double().cpu(), w.double().cpu()
        gap = (g - w).abs() / w.abs().clamp(min=1e-30)
        state_rel = max(state_rel, float(gap[(g != w)].max()) if bool((g != w).any()) else 0.0)
        if not torch.allclose(g, w, rtol=SCAN_STATE_RTOL, atol=0.0):
            fail("%s: carried %s beyond rtol %g" % (label, name, SCAN_STATE_RTOL))
    errs = _scan_errors(calls, label)
    lib_inputs = [xs[0].reshape(xs[0].shape[0], -1).T.contiguous()
                  for key, xs, _rev in calls if key != "affine"]
    times = {"kernel": [], "plain": [], "library": []}
    fns = {"kernel": lambda: [_run_scan(c, False) for c in calls],
           "plain": lambda: [_run_scan(c, True) for c in calls],
           # torch.cumsum along the innermost dim of each non-affine scan's
           # transposed, contiguous [C, N] (never called by the port)
           "library": lambda: [torch.cumsum(t, dim=-1, dtype=t.dtype) for t in lib_inputs]}
    for route in ("plain", "kernel", "library", "library", "kernel", "plain"):
        times[route].append(median_ms(fns[route]))
    best = {k: min(v) for k, v in times.items()}
    bounds = scan_bounds(calls)
    shapes = sorted({"%s %r %s" % (key, tuple(xs[0].shape), str(xs[0].dtype).replace("torch.", ""))
                     for key, xs, _rev in calls})
    out = {"launches": len(calls), "ms": best["kernel"], "plain_ms": best["plain"],
           "library_ms": best["library"], "bound_ms": max(bounds["bytes_ms"], bounds["ops_ms"]),
           "bound_by": "bytes" if bounds["bytes_ms"] >= bounds["ops_ms"] else "operations",
           "mbytes": bounds["mbytes"], "max_abs_err": errs["abs"], "max_rel_err": errs["rel"],
           "kernel_f64_rel": errs["kernel_f64"], "plain_f64_rel": errs["plain_f64"],
           "flips": flips, "labels_max_diff_others": rest, "state_max_rel": state_rel,
           "shapes": shapes}
    log("  %s: %d scans (%s); kernel %.4f ms, plain %.4f ms, torch.cumsum of the %d "
        "non-affine ones %.4f ms (medians of 15, best of 2 turns: %s); bound %.4f ms by %s "
        "(%.1f MB at 3.35 TB/s; operations %.4f ms); max |kernel - plain| %.4g (%.3g of "
        "max |plain|); from float64 the kernel %.3g, plain %.3g; labels %d windows a vote "
        "apart; state within %.3g"
        % (label, len(calls), "; ".join(shapes), best["kernel"], best["plain"],
           len(lib_inputs), best["library"], json.dumps(times), out["bound_ms"],
           out["bound_by"], bounds["mbytes"], bounds["ops_ms"], errs["abs"], errs["rel"],
           errs["kernel_f64"], errs["plain_f64"], flips, state_rel))
    return out


def scan_phase(dev, pcm):
    """Phase 16: the scan kernel against its plain version at every path's
    shapes, timed beside plain, library and bound. Returns {path: dict}."""
    import torch

    from ffsubsync_tpu_torch.ops import _build, scan, vad
    from ffsubsync_tpu_torch.parallel import vad_shard

    if _build.load_library().ffs_scan_tile_rows() != scan.TILE_ROWS:
        fail("csrc/scan.cu tiles %d rows, ops/scan.py says %d"
             % (_build.load_library().ffs_scan_tile_rows(), scan.TILE_ROWS))
    window = RATE // SAMPLE_RATE
    out = {}
    for label, windows in SCAN_PATHS.items():
        x = _staged(pcm, windows)

        def run(x=x, windows=windows):
            labels, state = vad._vad_program(x, window, RATE, windows, vad.initial_state(dev),
                                              None, 0.0, "webrtc")
            return labels, {k: state[k] for k in ("ema", "noise", "prev_m", "prev_m_len",
                                                  "prev_ldb", "prev_ldb_len")}

        out[label] = _scan_path(label, run, 1)
        del x
    card = torch.device("cuda", 0)
    det = vad_shard.make_sharded_detector([card] * 4, "webrtc", SAMPLE_RATE, RATE, 0.0)
    staged = det.stage(pcm)
    out["sp"] = _scan_path("sp (4 shards of cuda:0)", lambda: (det.run(*staged), None), 4)
    return out


def vad_program_routes(dev, pcm):
    """Phase 16: one ``_vad_program`` per mode on a 45-minute chunk, its
    scans by the kernel and by the plain version, in turns (plain, kernel,
    kernel, plain). Returns {mode: {route: ms}}."""
    from ffsubsync_tpu_torch.models.neural_vad import load_net
    from ffsubsync_tpu_torch.ops import vad

    n = SCAN_PATHS["fused"]
    x = _staged(pcm, n)
    window = RATE // SAMPLE_RATE
    out = {}
    for mode in VAD_MODES:
        net = None if mode == "webrtc" else load_net(RATE, dev)
        times = {"plain": [], "kernel": []}
        for route in ("plain", "kernel", "kernel", "plain"):
            with ScanCalls(plain=route == "plain", record=False):
                times[route].append(median_ms(lambda: vad._vad_program(
                    x, window, RATE, n, vad.initial_state(dev), net, 0.0, mode), n=5, warm=2))
        out[mode] = {route: min(v) for route, v in times.items()}
        log("  _vad_program %s, 45-min chunk [%d, %d]: scans by the kernel %.3f ms, by the "
            "plain version %.3f ms (CUDA events, median of 5, best of 2 turns: %s)"
            % (mode, n, window, out[mode]["kernel"], out[mode]["plain"], json.dumps(times)))
    return out


def sync_free_dispatch(dev, pcm):
    """Phase 16: ``dispatch_async`` of the whole 90 minutes (two pipeline
    chunks) under ``torch.cuda.set_sync_debug_mode("error")`` for webrtc,
    silero and fused, each on a fresh detector after a warm one made the
    constants: any host sync while the chunks are staged and queued
    raises. Beside it, the fused detector with the copies the port made
    before (staged in pageable memory and copied by a plain
    ``.to(device)``, the band weights copied per chunk):
    the seconds until ``dispatch_async`` returns and until the card is
    done, for each. Returns a dict of them."""
    import numpy as np
    import torch

    from ffsubsync_tpu_torch.ops import frontend as fe
    from ffsubsync_tpu_torch.ops import scan, vad
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input

    def dispatch(mode, sync_debug):
        det = vad.make_detector(mode, SAMPLE_RATE, RATE, 0.0, dev)
        torch.cuda.synchronize()
        fe.fused_frontend.launches = 0
        scan.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(sync_debug)
        try:
            handles = det.dispatch_async(pcm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        done = time.perf_counter() - t0
        labels = det.gather(handles).materialize()
        scans = scan.launches
        if (len(labels) != MINUTES * 60 * SAMPLE_RATE or not np.isfinite(labels).all()
                or fe.fused_frontend.launches != len(handles)):
            fail("dispatch_async %s: %d labels, %d frontend launches for %d chunks"
                 % (mode, len(labels), fe.fused_frontend.launches, len(handles)))
        _check_scans("dispatch_async " + mode, scans, 0 if mode == "silero" else len(handles))
        return {"queued_s": queued, "done_s": done, "chunks": len(handles)}

    out = {}
    for mode in ("webrtc", "silero", "fused"):
        dispatch(mode, "default")  # the warm-up makes the cached constants
        out[mode] = dispatch(mode, "error")
        log("  dispatch_async %s, 90 min in %d chunks, under sync-debug error: queued in "
            "%.4f s, the card done at %.4f s" % (mode, out[mode]["chunks"],
                                                out[mode]["queued_s"], out[mode]["done_s"]))
    def pageable(pcm_i16, frame_rate, sample_rate, device):
        framed, rate, window, n_windows = prepare_staged_input(pcm_i16, frame_rate, sample_rate)
        return torch.from_numpy(framed).to(device), rate, window, n_windows

    real = (vad.stage_to_device, vad._band_weights)
    vad.stage_to_device = pageable
    vad._band_weights = lambda device: torch.from_numpy(vad._BAND_WEIGHTS).to(device)
    try:
        blocking = [dispatch("fused", "default") for _ in range(3)]
    finally:
        vad.stage_to_device, vad._band_weights = real
    sync_free = [dispatch("fused", "default") for _ in range(3)]
    for name, runs in (("pageable copies, as before", blocking), ("pinned copies", sync_free)):
        out["fused " + name] = {k: sorted(r[k] for r in runs)[1] for k in ("queued_s", "done_s")}
        log("  dispatch_async fused with %s: queued in %s s, the card done at %s s (3 runs)"
            % (name, ["%.4f" % r["queued_s"] for r in runs], ["%.4f" % r["done_s"] for r in runs]))
    return out


def measure(workdir, wav_path, pcm, batch_jobs, runs=6):
    """The ``--measure`` phases (see the module docstring)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ffsubsync_tpu_torch import sync
    from ffsubsync_tpu_torch.models.neural_vad import load_net
    from ffsubsync_tpu_torch.ops import vad
    from ffsubsync_tpu_torch.ops.features import prepare_staged_input
    from ffsubsync_tpu_torch.parallel.batch import BatchAligner

    # 1. wall seconds of repeated runs of every path in this process
    def run_sync(label):
        result, wall = _timed_sync(workdir, wav_path, label)
        _check_result(label, result)
        return wall

    def run_batch():
        results, wall = _timed_batch(batch_jobs)
        _check_batch(results)
        return wall

    warm_median = {}
    paths = [(label, lambda label=label: run_sync(label))
             for label in ("fused", "default", "auditok", "multiseg")]
    for label, run in paths + [("batch", run_batch)]:
        walls = [run() for _ in range(runs)]
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

    real = (vad.stage_to_device, vad._vad_program, sync.align_candidates)
    vad.stage_to_device = timed("host staging and copy", real[0])
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
        vad.stage_to_device, vad._vad_program, sync.align_candidates = real

    # the share of one warm batch spent in the batched search
    spent.clear()
    real_batch = BatchAligner.align_batch
    BatchAligner.align_batch = timed("batched search", real_batch)
    try:
        _results, wall = _timed_batch(batch_jobs)
    finally:
        BatchAligner.align_batch = real_batch
    _check_batch(_results)
    log("breakdown batch of %d x %d min: wall %.4f s; batched search %.4f s "
        "(%.4f of the wall)" % (len(batch_jobs), EPISODE_SECONDS // 60, wall,
                                spent["batched search"],
                                spent["batched search"] / wall))

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
    ptxas, spills, sass_mma = build()
    import torch

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ffs_chip_smoke_") as workdir:
        wav_path, pcm, spans = synthesize(workdir)
        if opts.measure:
            measure(workdir, wav_path, pcm, make_batch_jobs(workdir, pcm, spans))
            log(smi)
            return
        worst = kernel_vs_plain(dev)
        chunk = chunk_check_and_time(dev, pcm)
        chunk_errs = chunk["errs"]
        results = main_path(workdir, wav_path)
        for label in ("fused", "default"):
            # the same pick as before the scan kernel: 7.34 s, to the window
            if results[label][2] > 0.5 / SAMPLE_RATE:
                fail("%s sync: offset %.3f s from the truth, not the same window"
                     % (label, results[label][2]))
        agree = labels_card_vs_cpu(pcm)
        results["auditok"] = auditok_phase(workdir, wav_path, pcm, dev)
        results["multiseg"] = multiseg_phase(workdir, wav_path)
        results["batch"] = batch_phase(make_batch_jobs(workdir, pcm, spans))
        results["sp"] = sp_phase(pcm, spans)
        results["fused_sp_env"] = (sp_gate_phase(workdir, wav_path, results["fused"][0]),)
        train = train_phase(dev, pcm)
        results["train"] = (train["launches"],)
        results["eval"] = eval_phase()
        results["agree"] = (results["eval"][3],)
        eval_errs = results["eval"][2]
        pair = pair_phase(dev, spans)
        results["pair"] = (pair["launches"],)
        t13 = time.perf_counter()
        babble = babble_phase(dev)
        results["babble"] = (babble["launches"],)
        results["jitter"] = jitter_phase()
        results["bias"] = bias_phase()
        log("phase 13 (the probes) took %.1f s" % (time.perf_counter() - t13))
        t14 = time.perf_counter()
        benches = bench_phase(dev, pcm, smi)
        for script, launches in benches["launches"].items():
            results[script] = (launches,)
        log("phase 14 (the benchmark scripts) took %.1f s" % (time.perf_counter() - t14))
        t15 = time.perf_counter()
        diag = diag_phase(dev, workdir, wav_path, smi)
        for script, launches in diag["launches"].items():
            results[script] = (launches,)
        results["profile"] = (diag["profile"]["launches"],)
        log("phase 15 (the stage diagnostics, --profile-dir) took %.1f s"
            % (time.perf_counter() - t15))
        t16 = time.perf_counter()
        scans = scan_phase(dev, pcm)
        routes = vad_program_routes(dev, pcm)
        dispatch = sync_free_dispatch(dev, pcm)
        log("phase 16 (the scan kernel, the sync-free dispatch) took %.1f s"
            % (time.perf_counter() - t16))
    log("phases done in %.1f s; 90-min sync walls: fused %.3f s, default %.3f s, "
        "auditok %.3f s, multi-segment %.3f s; batch of %d x %d min %.3f s; fused "
        "label agreement %.5f, auditok %.6f; sharded against monolithic labels: "
        "at most %d windows a vote apart, the others within %.3g"
        % (time.perf_counter() - t_all, results["fused"][1], results["default"][1],
           results["auditok"][1], results["multiseg"][1], len(BATCH_JOBS),
           EPISODE_SECONDS // 60, results["batch"][1], agree, results["auditok"][3],
           results["sp"][2][0], results["sp"][2][1]))
    auditok_errs, multiseg_errs = results["auditok"][4], results["multiseg"][3]
    shard_errs = results["sp"][1]
    log("training: %d steps %.3f s wall, %.4f card ms and %.3f host synthesis ms per step, "
        "held-out accuracy %.4f; eval card vs CPU worst accuracy difference %.4f"
        % (TRAIN_STEPS, train["wall"], train["step_ms"], train["synth_ms"], train["accuracy"],
           results["eval"][1]))
    log("raw-signal alignment of %d-point pairs: card search %s ms; probes: babble %s, noisy "
        "jitter cells %s, webrtc bias errors %s s"
        % (pair["n"], json.dumps(pair["card_ms"]), json.dumps(babble["report"]),
           json.dumps(results["jitter"][1]["cells"]), json.dumps(results["bias"][1])))
    kernels = {
        "kernels": [
            {
                "name": "fused_frontend",
                "route": "cuda",
                "source": "ffsubsync_tpu_torch/csrc/frontend.cu",
                "replaces": "ffsubsync_tpu/ops/pallas/frontend.py:225",
                "launches": results["fused"][0],
                # worst log-mel abs error over every comparison (phases 3, 6,
                # 7, 9, 10, 11, 13, 14 and 15)
                "max_abs_err": max([worst["logmel"], chunk_errs["logmel"],
                                    auditok_errs["logmel"], multiseg_errs["logmel"],
                                    shard_errs["logmel"]]
                                   + [e["logmel"] for e in train["errs"].values()]
                                   + [e["logmel"] for e in eval_errs.values()]
                                   + [e["logmel"] for e in babble["errs"].values()]
                                   + [results["jitter"][2]["logmel"], benches["errs"]["logmel"],
                                      diag["errs"]["logmel"]]),
                # all three outputs at each path's own launch shape
                "chunk_max_abs_err": chunk_errs,
                "auditok_max_abs_err": auditok_errs,
                "multiseg_max_abs_err": multiseg_errs,
                "sp_shard_max_abs_err": shard_errs,
                # the trainer's launch shapes (phase 10: its batch at 12 and
                # 48 kHz, its held-out pass), each with its kernel and plain
                # milliseconds
                "train_max_abs_err": train["errs"],
                # the adversarial eval's and the agreement harness's first
                # staged inputs (phase 11)
                "eval_max_abs_err": eval_errs,
                # the babble probe's training and scoring launches, and the
                # jitter probe's first staged movie (phase 13)
                "babble_max_abs_err": babble["errs"],
                "jitter_max_abs_err": results["jitter"][2],
                # bench_suite wav5_energy's whole 5-min signal (phase 14)
                "wav5_max_abs_err": benches["errs"],
                "wav5_plain_ms": benches["plain_ms"],
                "wav5_bound_ms": benches["bound_ms"],
                "wav5_host_ms": benches["host_ms"],
                # diag_chunks' 600-s chunk [60000, 120] int8 (phase 15)
                "chunks600_max_abs_err": diag["errs"],
                "chunks600_ms": diag["ms"],
                "chunks600_plain_ms": diag["plain_ms"],
                "chunks600_bound_ms": diag["bound_ms"],
                "chunks600_host_ms": diag["host_ms"],
                "babble_plain_ms": babble["plain_ms"],
                "babble_bound_ms": babble["bound_ms"],
                "babble_host_ms": babble["host_ms"],
                "train_ms": train["ms"],
                "train_host_ms": train["host_ms"],
                "train_plain_ms": train["plain_ms"],
                # at the 45-minute chunk [270000, 120] int8 (CUDA events)
                "ms": chunk["ms"],
                "plain_ms": chunk["plain_ms"],
                # the larger of the float32 operations the function needs
                # at 67 TFLOP/s and the bytes at 3.35 TB/s (frontend_bounds)
                "bound_ms": max(chunk["bounds"]["ops_ms"], chunk["bounds"]["bytes_ms"]),
                "bound_by": ("operations" if chunk["bounds"]["ops_ms"]
                             >= chunk["bounds"]["bytes_ms"] else "bytes"),
                "bound_ops_ms": chunk["bounds"]["ops_ms"],
                "bound_bytes_ms": chunk["bounds"]["bytes_ms"],
                "bound_tf32_ms": chunk["bounds"]["tf32_ms"],
                # torch.matmul float32 of the decoded frame by the [W, 2F]
                # basis (cuBLAS; never called by the port)
                "library_ms": chunk["library_ms"],
                "ms_by_path": dict(chunk["ms_by_path"], **{
                    "babble " + shape: ms for shape, ms in babble["ms"].items()},
                    **{"wav5 " + benches["shape"]: benches["ms"],
                       "chunks600 " + diag["shape"]: diag["ms"]}),
                "windows_by_path": PATH_WINDOWS,
                "config": chunk["config"],
                "ptxas": ptxas,
                "spill_bytes": spills,
                "sass_mma": sass_mma,
                # launches of each path's own run (phases 4, 6-14; "sp" is
                # one sharded call on 4 shards, "fused_sp_env" the CLI sync
                # with FFS_TPU_SP_VAD=1, "train" the trainer's steps and
                # held-out pass, "eval" the card's adversarial eval, "agree"
                # the agreement harness's syncs, "pair" the raw-signal
                # searches (no kernel), "babble", "jitter" and "bias" the
                # probes, the last summed over its harness's process;
                # "bench", "bench_batch" and "bench_suite" the benchmark
                # scripts, "diag_breakdown" and "diag_chunks" the stage
                # diagnostics, each over its own process; "profile" the
                # --profile-dir sync)
                "path_launches": {label: r[0] for label, r in results.items()},
            },
            {
                "name": "webrtc_scan",
                "route": "cuda",
                "source": "ffsubsync_tpu_torch/csrc/scan.cu",
                "replaces": "ffsubsync_tpu/ops/vad.py:202",
                # phase 4's fused sync: 8 scans per chunk
                "launches": SCAN_PATH_LAUNCHES["fused"],
                # over every scan at every path's shapes (phase 16): add
                # and affine within SCAN_RTOL of max |plain|, min and max
                # exact
                "max_abs_err": max(p["max_abs_err"] for p in scans.values()),
                "max_rel_err": max(p["max_rel_err"] for p in scans.values()),
                # the detector's labels, kernel against plain route: windows
                # a whole vote apart, at most SP_FLIPS of them
                "flips": {label: p["flips"] for label, p in scans.items()},
                # the 8 scans of one 45-minute chunk (CUDA events)
                "ms": scans["fused"]["ms"],
                "plain_ms": scans["fused"]["plain_ms"],
                "bound_ms": scans["fused"]["bound_ms"],
                "bound_by": scans["fused"]["bound_by"],
                # torch.cumsum over the transposed [C, N] of the 7 scans
                # that are no affine pair (that one has no library call)
                "library_ms": scans["fused"]["library_ms"],
                "by_path": scans,
                "vad_program_ms": routes,
                "dispatch": dispatch,
                # launches of each path's own run (as the frontend's above;
                # "sp" the one sharded call on 4 shards)
                "path_launches": SCAN_PATH_LAUNCHES,
            },
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
