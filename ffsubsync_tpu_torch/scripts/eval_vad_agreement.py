# -*- coding: utf-8 -*-
"""Offset-agreement harness: does every ``--vad`` mode sync to the same
answer, end to end?

Counterpart of the JAX package's ``scripts/eval_vad_agreement.py``, every
sync through this package's CLI parser and ``sync.run`` (on the device
``FFS_TORCH_DEVICE`` names, or ``--platform``). Synthetic mode (default):
fabricates N perturbed movies with a KNOWN speech timeline
(models/eval_data.perturbed_movie scenarios: clean, µ-law, telephone,
noisy, music bed, applause/laughter interludes), shifts the subtitles by a
known per-movie offset, runs the full sync pipeline (``sync.run()`` with a
WAV reference) once per VAD mode, and reports each mode's offset MAE
against ground truth plus the worst cross-mode disagreement. The truth
draws and per-slot seeds are the reference harness's, so the two report on
the same movies.

Real-media mode: pass ``--pairs ref1.mkv:in1.srt [ref2:in2 ...]`` to run the
same cross-mode comparison on actual files (no ground truth; the report is
pairwise agreement).

Prints one JSON line; human details go to stderr.

    python -m ffsubsync_tpu_torch.scripts.eval_vad_agreement --check-bars
        [--seed 7919] [--vads fused,webrtc,silero]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from ffsubsync_tpu_torch.utils.fixtures import (
    write_srt_spans as _write_srt,
    write_wav_i16 as _write_wav,
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync_offset(reference, srtin, vad, tmpdir):
    from ffsubsync_tpu_torch.cli import make_parser
    from ffsubsync_tpu_torch.sync import run as sync_run

    out = os.path.join(tmpdir, "out_%s.srt" % vad.replace(":", "_"))
    args = make_parser().parse_args(
        [reference, "-i", srtin, "-o", out, "--vad", vad]
    )
    result = sync_run(args)
    return result["offset_seconds"]


# Length-variant scenario slots, appended AFTER the base scenarios so the
# base slots' truth draws stay unchanged: name -> (base scenario, minutes).
# noisy_10min exists so the 10 ms neural bar BINDS under the 4 dB pink bed
# somewhere: at 3-minute clip length the correlation peak jitters 1-3 cells
# (measured, weights-independent — scripts/probe_noisy_jitter.py is the
# reproducible protocol), so the 3-min `noisy` slot carries a 30 ms bar and
# this 10-minute slot carries the tight one. The *_10min music variants play
# the same role for the webrtc-class kernel: its 3-min music errors carry
# ±0.1-0.2 s of short-clip measurement variance (~40 spans under a bed —
# scripts/probe_webrtc_bias.py is the protocol), which collapses at
# 10-minute length, so the music families get their tighter webrtc bar here
# (0.15 s vs 0.25 s — see check_bars).
LENGTH_VARIANTS = {
    "noisy_10min": ("noisy", 10.0),
    "music_bed_10min": ("music_bed", 10.0),
    "vocals_bed_10min": ("vocals_bed", 10.0),
    "strings_bed_10min": ("strings_bed", 10.0),
}


def all_scenarios():
    from ffsubsync_tpu_torch.models.eval_data import MOVIE_SCENARIOS

    return tuple(MOVIE_SCENARIOS) + tuple(LENGTH_VARIANTS)


def run_synthetic(vads, minutes, frame_rate, seed, scenarios=None):
    from ffsubsync_tpu_torch.models.eval_data import MOVIE_SCENARIOS, perturbed_movie

    rng = np.random.RandomState(seed)
    rows = []  # (scenario, truth, {vad: offset})
    tmpdir = tempfile.mkdtemp(prefix="ffs_agreement_")
    slots = [(name, name, minutes) for name in MOVIE_SCENARIOS] + [
        (name, base, mins) for name, (base, mins) in LENGTH_VARIANTS.items()
    ]
    try:
        for i, (scenario, base, slot_minutes) in enumerate(slots):
            truth_draw = round(float(rng.uniform(-20.0, 20.0)), 2)
            if scenarios and scenario not in scenarios:
                continue
            pcm, spans = perturbed_movie(
                base, slot_minutes * 60.0, frame_rate, seed=seed + i
            )
            truth = truth_draw  # drawn per scenario slot, selection-invariant
            wav = os.path.join(tmpdir, "%s.wav" % scenario)
            srt = os.path.join(tmpdir, "%s.srt" % scenario)
            _write_wav(wav, pcm, frame_rate)
            _write_srt(srt, [(a - truth, b - truth) for a, b in spans])
            offsets = {}
            for vad in vads:
                got = _sync_offset(wav, srt, vad, tmpdir)
                offsets[vad] = got
                log(
                    "  %-16s %-16s truth %+7.2f got %s"
                    % (
                        scenario,
                        vad,
                        truth,
                        "None" if got is None else "%+7.2f" % got,
                    )
                )
            rows.append((scenario, truth, offsets))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    report = {"mode": "synthetic", "per_vad_mae_s": {}, "per_scenario": {}}
    for vad in vads:
        errs = [
            abs(offsets[vad] - truth)
            for _, truth, offsets in rows
            if offsets[vad] is not None
        ]
        fails = sum(1 for _, _, offsets in rows if offsets[vad] is None)
        report["per_vad_mae_s"][vad] = round(float(np.mean(errs)), 3) if errs else None
        if fails:
            report["per_vad_mae_s"][vad + "_failures"] = fails
    for scenario, truth, offsets in rows:
        report["per_scenario"][scenario] = {
            "truth": truth,
            **{v: (None if o is None else round(o, 3)) for v, o in offsets.items()},
        }
    return report


def run_real(vads, pairs):
    rows = []
    tmpdir = tempfile.mkdtemp(prefix="ffs_agreement_")
    try:
        for ref, srtin in pairs:
            offsets = {}
            for vad in vads:
                offsets[vad] = _sync_offset(ref, srtin, vad, tmpdir)
                log("  %-40s %-16s -> %s" % (os.path.basename(ref), vad, offsets[vad]))
            rows.append((ref, offsets))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    report = {"mode": "real", "pairwise_max_disagreement_s": {}, "per_file": {}}
    pairwise = report["pairwise_max_disagreement_s"]
    for ref, offsets in rows:
        vals = [o for o in offsets.values() if o is not None]
        spread = round(max(vals) - min(vals), 3) if len(vals) > 1 else None
        report["per_file"][ref] = {**offsets, "spread_s": spread}
        # headline metric: worst cross-file disagreement per mode pair
        named = sorted((v, o) for v, o in offsets.items() if o is not None)
        for i, (va, oa) in enumerate(named):
            for vb, ob in named[i + 1 :]:
                key = "%s/%s" % (va, vb)
                d = round(abs(oa - ob), 3)
                if d > pairwise.get(key, -1.0):
                    pairwise[key] = d
    return report


# Offsets land on the 100 Hz label grid, so an error of exactly one cell is
# exactly the 10 ms bar — and ``1.8 - 1.79 > 0.010`` is True in float64 (the
# difference carries ~1e-16 of representation error). The bars are inclusive
# ("within 10 ms"), so comparisons get an epsilon far below one cell.
_BAR_EPS = 1e-9


def check_bars(report, frame_rate):
    """EVAL.md's binding bars over a synthetic-mode report → violation list.

    Neural backends (fused/silero) must land within 10 ms of truth on every
    scenario except ``noisy``, whose bar is 30 ms (three label cells): under
    a 4 dB pink bed the 3-minute clip's correlation peak jitters by 1-3
    cells with random sign and backend — measured across seeds 0/100/200/300
    the deviation struck silero at one seed and fused at two others, struck
    the PREVIOUS shipped net identically (so it is not a property of any
    particular weights), and vanished at 10-minute clip length (silero
    exact, fused one cell) — i.e. it is the short-clip variance of the
    measurement, not detector bias (reproduce with
    scripts/probe_noisy_jitter.py). The ``noisy_10min`` length-variant slot
    therefore carries the DEFAULT 10 ms neural bar: the same pink bed binds
    tightly at the clip length where the jitter vanishes.

    The webrtc-class kernel is bound only at the default 12 kHz tier, at
    250 ms on every 3-minute scenario and 150 ms on the 10-minute music
    variants. Those bars are the measured tuning-family envelope
    (seeds 1-8, scripts/probe_webrtc_bias.py / EVAL_webrtc_bias.json), set
    AFTER the pre-hangover symmetrization zeroed the kernel's systematic
    late bias (ops/vad.py constants block): the residual is ±0.1-0.2 s of
    short-clip measurement variance at 3 minutes, shrinking to ≤0.12 s at
    10 minutes. The first certification run exposed that the previous
    10 ms music bars were a seed-0 sampling fluke (21/24 tuning-family
    slots missed them), so they were re-derived from the multi-seed
    distribution — the honest comparison point stays real webrtcvad, whose
    music-bed failure is catastrophic (tens of seconds; see EVAL.md).
    orchestra_bed keeps its documented onset-bias allowance inside the
    same 250 ms bound. A failed sync (None offset) violates the bar it
    would otherwise be measured against.
    """
    failures = []
    webrtc_tight = ("music_bed_10min", "vocals_bed_10min", "strings_bed_10min")
    for name, row in report["per_scenario"].items():
        truth = row["truth"]
        for vad in ("fused", "silero"):
            if vad not in row:
                continue
            neural_bar = 0.030 if name == "noisy" else 0.010
            if row[vad] is None:
                failures.append("%s %s failed to sync" % (name, vad))
            elif abs(row[vad] - truth) > neural_bar + _BAR_EPS:
                failures.append(
                    "%s %s off by %.3f s (> %.0f ms bar)"
                    % (name, vad, abs(row[vad] - truth), neural_bar * 1000)
                )
        if "webrtc" in row and frame_rate == 12000:
            bar = 0.150 if name in webrtc_tight else 0.250
            if row["webrtc"] is None:
                failures.append("%s webrtc failed to sync" % name)
            elif abs(row["webrtc"] - truth) > bar + _BAR_EPS:
                failures.append(
                    "%s webrtc off by %.3f s (> %.0f ms bar)"
                    % (name, abs(row["webrtc"] - truth), bar * 1000)
                )
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vads", default="fused,webrtc,silero,auditok")
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--frame-rate", type=int, default=12000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--scenarios",
        default=None,
        help="comma-separated scenario subset (default: all); truths and "
        "per-scenario seeds are unchanged by the selection",
    )
    ap.add_argument(
        "--pairs",
        nargs="*",
        help="real media: reference:srtin pairs (skips synthetic mode)",
    )
    ap.add_argument("--platform", default=None, choices=("cuda", "cpu"),
                    help="device (sets FFS_TORCH_DEVICE for the syncs)")
    ap.add_argument(
        "--check-bars",
        action="store_true",
        help="enforce EVAL.md's binding end-to-end bars on the synthetic "
        "report (exit 1 on violation): neural backends within 10 ms on "
        "every scenario (30 ms on 'noisy' — measured short-clip jitter; "
        "see check_bars); at the 12 kHz tier the webrtc-class kernel "
        "within 10 ms on the gate-silenced music families and 150 ms "
        "everywhere",
    )
    args = ap.parse_args(argv)
    if args.platform:
        os.environ["FFS_TORCH_DEVICE"] = args.platform
    vads = args.vads.split(",")
    if args.pairs:
        pairs = [tuple(p.rsplit(":", 1)) for p in args.pairs]
        report = run_real(vads, pairs)
    else:
        subset = args.scenarios.split(",") if args.scenarios else None
        if subset:
            known = all_scenarios()
            unknown = [s for s in subset if s not in known]
            if unknown:
                # a typo'd subset must not produce an empty report that
                # --check-bars then waves through as green
                ap.error(
                    "unknown scenario(s) %s (known: %s)"
                    % (",".join(unknown), ",".join(known))
                )
        report = run_synthetic(
            vads, args.minutes, args.frame_rate, args.seed, scenarios=subset
        )
    from ffsubsync_tpu_torch.ops.frontend import fused_frontend

    # read by probe_webrtc_bias, which runs this harness in processes of its own
    log("frontend kernel launches: %d" % fused_frontend.launches)
    print(json.dumps(report))
    if args.check_bars and not args.pairs:
        failures = check_bars(report, args.frame_rate)
        if failures:
            print(
                "EVAL BARS VIOLATED:\n  " + "\n  ".join(failures),
                file=sys.stderr,
            )
            return 1
        print("eval bars OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
