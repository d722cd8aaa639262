#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Per-stage breakdown of the 90-min headline bench (diagnostic).

Counterpart of the JAX package's ``scripts/diag_breakdown.py``, with its
arguments, its stages and its stderr lines. It splits the device path of
one 90-minute sync (the problem of ``scripts/bench.make_problem``) into
stages, each timed on its own, best of ``runs`` on the host's clock:

- ``stage_host``: host staging (decimate, mu-law, frame) of every pipeline
  chunk;
- ``xfer``: the host-to-device copy of the staged bytes, made as the VAD
  path makes it (``torch.from_numpy(framed).to(device)`` from pageable
  memory), then a synchronize;
- ``vad[mode]``: the whole VAD pipeline per ``--vad`` mode, staging, copy
  and the card's work (``dispatch_async``, ``gather``, a synchronize).
  ``webrtc`` loads no net, ``silero`` runs only the net, ``fused`` both,
  so fused minus webrtc is the net's cost. The reference's docstring
  promises this stage on device-resident inputs; its code, and this
  script, time staging and copy with it. The card's time per chunk
  program is ``chip_smoke.py --measure``'s;
- ``align``: the batched candidate search on the fused signal, its labels
  on the device;
- ``pull``: the one pull of the labels to the host, after a synchronize.

Detectors are built outside the timed windows. It runs on the card
(``FFS_TORCH_DEVICE`` unset or ``cuda``) and raises without one;
``FFS_TORCH_DEVICE=cpu`` runs the port's plain PyTorch path on the CPU.
The last stderr line is ``frontend kernel launches: N`` over the run.
A runs count below 1 raises ``ValueError``, where the reference dies with
an ``IndexError`` at its first best time.

Usage: python -m ffsubsync_tpu_torch.scripts.diag_breakdown [minutes] [runs]
"""
import sys
import time

import torch

from ffsubsync_tpu_torch.constants import SAMPLE_RATE
from ffsubsync_tpu_torch.device import get_device
from ffsubsync_tpu_torch.ops.align import align_candidates
from ffsubsync_tpu_torch.ops.features import analysis_rate, prepare_staged_input
from ffsubsync_tpu_torch.ops.vad import _pipeline_chunk_samples, make_detector
from ffsubsync_tpu_torch.scripts.bench import card_line, log, log_launches, make_problem

MODES = ("webrtc", "silero", "fused")


def parse_argv(argv):
    """``[minutes] [runs]``, defaults 90 and 4; fewer than one run raises."""
    minutes = float(argv[0]) if len(argv) > 0 else 90.0
    runs = int(argv[1]) if len(argv) > 1 else 4
    if runs < 1:
        raise ValueError("runs=%d: at least one run is needed" % runs)
    return minutes, runs


def describe(device):
    """``device`` and, on a card, its ``nvidia-smi`` name and power limit."""
    return " ".join(str(part) for part in (device, card_line(device)) if part)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_of(fn, n):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts


def pipeline_chunks(pcm, frame_rate):
    """``pcm`` cut where the VAD pipeline cuts it (one piece when
    ``FFS_TPU_PIPELINE_SECONDS`` is 0)."""
    chunk = _pipeline_chunk_samples(frame_rate, SAMPLE_RATE) or len(pcm)
    return [pcm[p : p + chunk] for p in range(0, len(pcm), chunk)]


def stage_host(chunks, frame_rate):
    """Stage 1: each chunk staged on the host, ``(framed, rate, window,
    n_windows)``."""
    return [prepare_staged_input(c, frame_rate, SAMPLE_RATE) for c in chunks]


def xfer(staged, device):
    """Stage 2: the staged frames copied to ``device`` as the VAD path
    copies them."""
    bufs = [torch.from_numpy(framed).to(device) for framed, _r, _w, _n in staged]
    synchronize(device)
    return bufs


def vad(detector, pcm, device):
    """Stage 3: one pass of the VAD pipeline over ``pcm``; its labels,
    computed, stay on ``device``."""
    signal = detector.gather([detector.dispatch_async(pcm)])
    synchronize(device)
    return signal


def align(signal, candidates):
    """Stage 4: the batched candidate search."""
    return align_candidates(signal, candidates, max_offset_samples=60 * SAMPLE_RATE)


def pull(signal):
    """Stage 5: the labels' pull to the host. Returns (labels, seconds)."""
    t0 = time.perf_counter()
    labels = signal.materialize()
    return labels, time.perf_counter() - t0


def _times(ts):
    return [round(x, 3) for x in ts]


def main(argv=None):
    minutes, runs = parse_argv(sys.argv[1:] if argv is None else argv)
    device = get_device()
    frame_rate = analysis_rate(48000, SAMPLE_RATE)
    log("device:", describe(device), "| analysis rate", frame_rate)

    pcm, spans, _sub_spans, candidates, _ratios = make_problem(minutes, frame_rate)
    log("%d spans, %d samples (%.1f MB i16)" % (len(spans), len(pcm), pcm.nbytes / 1e6))
    chunks = pipeline_chunks(pcm, frame_rate)
    log("%d pipeline chunks of %d samples" % (len(chunks), len(chunks[0])))

    staged = stage_host(chunks, frame_rate)  # warm
    ts = best_of(lambda: stage_host(chunks, frame_rate), runs)
    log("stage_host   best %.3f s  all %s" % (ts[0], _times(ts)))
    wire_mb = sum(framed.nbytes for framed, _r, _w, _n in staged) / 1e6
    log("wire bytes: %.1f MB" % wire_mb)

    xfer(staged, device)
    ts = best_of(lambda: xfer(staged, device), runs)
    log("xfer         best %.3f s  all %s  (%.0f MB/s best)"
        % (ts[0], _times(ts), wire_mb / ts[0]))

    for mode in MODES:
        det = make_detector(mode, SAMPLE_RATE, frame_rate, 0.0, device)
        vad(det, pcm, device).materialize()  # warm
        ts = best_of(lambda: vad(det, pcm, device), runs)
        log("vad[%s] pipeline (stage+xfer+compute) best %.3f s  all %s"
            % (mode, ts[0], _times(ts)))

    det = make_detector("fused", SAMPLE_RATE, frame_rate, 0.0, device)
    signal = vad(det, pcm, device)
    align(signal, candidates)  # warm
    ts = best_of(lambda: align(signal, candidates), runs)
    log("align        best %.3f s  all %s" % (ts[0], _times(ts)))

    pulls = sorted(pull(vad(det, pcm, device))[1] for _ in range(runs))
    log("pull         best %.3f s  all %s" % (pulls[0], _times(pulls)))
    log_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
