# -*- coding: utf-8 -*-
"""Batch sync: many (reference, subtitles) jobs, one candidate search.

Counterpart of ``ffsubsync_tpu/batch.py``. Speech extraction runs per job
(decode overlapped by a thread pool, VAD as the usual one ``_vad_program``
per pipeline chunk on the default device), then every job's
candidate-ratio search is scored in one
:class:`~ffsubsync_tpu_torch.parallel.batch.BatchAligner` call over the
device mesh, each device's group of jobs a stacked leading dimension.

Library surface::

    from ffsubsync_tpu_torch.batch import sync_batch
    results = sync_batch([(ref1, in1, out1), (ref2, in2, out2), ...])

CLI (``ffs-torch-batch``)::

    ffs-torch-batch manifest.tsv        # lines: reference<TAB>srtin<TAB>srtout
    ffs-torch-batch --vad fused --gss manifest.tsv

Every single-file reference kind works here (subtitles, serialized
npy/npz, PGS streams, multi-segment sampling, plain video/audio), because
the dispatch is this port's ``sync.make_reference_extractor``. ``--gss``
refines each job's framerate ratio with batched grid rounds: one search per
round scores every job's ratio grid.
"""
import argparse
import concurrent.futures
import logging
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ffsubsync_tpu_torch.constants import (
    DEFAULT_FRAME_RATE,
    DEFAULT_MAX_FRAMERATE_DEVIATION,
    DEFAULT_MAX_OFFSET_SECONDS,
    DEFAULT_MAX_SUBTITLE_SECONDS,
    DEFAULT_MIN_SCORE,
    DEFAULT_NON_SPEECH_LABEL,
    DEFAULT_PARALLEL_WORKERS,
    DEFAULT_QUALITY_MAX_OFFSET_SECONDS,
    DEFAULT_SEGMENT_COUNT,
    DEFAULT_START_SECONDS,
    DEFAULT_VAD,
    FRAMERATE_RATIOS,
    SAMPLE_RATE,
    SUBTITLE_EXTENSIONS,
)
from ffsubsync_tpu_torch.subs.transforms import shift_document

logger = logging.getLogger(__name__)


def _make_ref_source(reference: str, vad: str, frame_rate: int,
                     ref_options: Optional[Dict[str, Any]] = None) -> Any:
    """Reference dispatch via this port's single-file
    ``make_reference_extractor``; a minimal argparse-style namespace
    carries the per-batch options."""
    from ffsubsync_tpu_torch.validation import reference_format
    from ffsubsync_tpu_torch.sync import make_reference_extractor

    opts = dict(ref_options or {})
    ref_format = reference_format(reference)
    ns = argparse.Namespace(
        reference=reference,
        # a non-movie reference never consults the VAD; leaving it unset
        # skips the single-file path's "vad specified but reference was not
        # a movie" warning, which would fire once per manifest line
        vad=(
            None
            if ref_format in SUBTITLE_EXTENSIONS or ref_format in ("npy", "npz")
            else vad
        ),
        frame_rate=frame_rate,
        non_speech_label=DEFAULT_NON_SPEECH_LABEL,
        reference_encoding=None,
        max_subtitle_seconds=opts.get("max_subtitle_seconds", DEFAULT_MAX_SUBTITLE_SECONDS),
        start_seconds=opts.get("start_seconds", DEFAULT_START_SECONDS),
        strict=False,
        pgs_ref_stream=opts.get("pgs_ref_stream"),
        reference_stream=opts.get("reference_stream"),
        multi_segment_sync=opts.get("multi_segment_sync", False),
        segment_count=opts.get("segment_count", DEFAULT_SEGMENT_COUNT),
        skip_intro_outro=opts.get("skip_intro_outro", False),
        parallel_workers=opts.get("parallel_workers", DEFAULT_PARALLEL_WORKERS),
        max_duration_seconds=opts.get("max_duration_seconds"),
        extract_audio_first=False,
        ffmpeg_path=opts.get("ffmpeg_path"),
        vlc_mode=False,
        gui_mode=False,
    )
    return make_reference_extractor(ns)


def sync_batch(
    jobs: Sequence[Tuple[str, str, str]],
    vad: str = DEFAULT_VAD,
    frame_rate: int = DEFAULT_FRAME_RATE,
    max_offset_seconds: float = DEFAULT_MAX_OFFSET_SECONDS,
    no_fix_framerate: bool = False,
    gss: bool = False,
    decode_workers: int = 4,
    mesh: Optional[Sequence[Any]] = None,
    output_encoding: str = "utf-8",
    min_score: float = DEFAULT_MIN_SCORE,
    quality_max_offset_seconds: float = DEFAULT_QUALITY_MAX_OFFSET_SECONDS,
    max_framerate_deviation: float = DEFAULT_MAX_FRAMERATE_DEVIATION,
    ref_options: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """Sync every ``(reference, srtin, srtout)`` job; one batched search.

    ``srtout`` must be a path for every job. With ``gss``, the discrete
    grid search is followed by batched grid-refinement rounds (the batch
    form of ``sync._run_gss_search``). Extraction runs on the device
    ``FFS_TORCH_DEVICE`` names (:mod:`ffsubsync_tpu_torch.device`); the
    search is split over ``mesh``, a sequence of devices (default: every
    local device of that kind). Returns one result dict per job:
    ``{reference, srtin, srtout, offset_seconds, framerate_scale_factor,
    sync_was_successful, quality_reasons, error}``.

    ``output_encoding`` follows the single-file flag's semantics ("same"
    preserves each input's detected encoding); ``ref_options`` forwards
    reference-extraction settings (pgs_ref_stream, multi_segment_sync,
    segment_count, start_seconds, ...) to ``make_reference_extractor``.
    """
    from ffsubsync_tpu_torch.speech import make_subtitle_speech_source
    from ffsubsync_tpu_torch.subs.parser import make_subtitle_parser
    from ffsubsync_tpu_torch.sync import assess_alignment_quality
    from ffsubsync_tpu_torch.parallel.batch import BatchAligner

    for reference, srtin, srtout in jobs:
        if not srtout:
            raise ValueError(
                "every batch job needs an output path (got none for %r)" % (srtin,)
            )
    results: List[Dict[str, Any]] = [
        {
            "reference": r,
            "srtin": s,
            "srtout": o,
            "offset_seconds": None,
            "framerate_scale_factor": None,
            "sync_was_successful": False,
            "quality_reasons": [],
            "error": None,
        }
        for r, s, o in jobs
    ]

    # --- speech extraction (decode is I/O-bound; VAD runs on the device) ---
    def _extract(idx: int):
        reference = jobs[idx][0]
        source = _make_ref_source(reference, vad, frame_rate, ref_options)
        source.fit(reference)
        return source

    ref_sources: List[Optional[Any]] = [None] * len(jobs)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, decode_workers)) as pool:
        futures = {pool.submit(_extract, i): i for i in range(len(jobs))}
        for fut in concurrent.futures.as_completed(futures):
            i = futures[fut]
            try:
                ref_sources[i] = fut.result()
            except Exception as e:  # job-level isolation, as in try_sync
                logger.exception("failed to extract reference for job %d", i)
                results[i]["error"] = str(e)

    # --- candidate construction -------------------------------------------
    ratios = [1.0]
    if not no_fix_framerate:
        ratios += list(FRAMERATE_RATIOS) + [1.0 / r for r in FRAMERATE_RATIOS]
    refs: List[Any] = []
    sources_per_job: List[List[Any]] = []
    makers_per_job: List[Any] = []  # ratio -> fitted source (gss rounds)
    live: List[int] = []
    for i, (reference, srtin, _srtout) in enumerate(jobs):
        if ref_sources[i] is None:
            continue
        try:
            fmt = (os.path.splitext(srtin)[-1][1:] or "srt") if srtin else "srt"
            parser = make_subtitle_parser(fmt=fmt, caching=True)

            # bind this job's fmt/parser/srtin NOW: the gss rounds call the
            # maker after the loop, and a late-binding closure would build
            # every job's sources from the LAST job's subtitle file
            def maker(r, fmt=fmt, parser=parser, srtin=srtin):
                return make_subtitle_speech_source(r, fmt=fmt, parser=parser).fit(srtin)

            sub_sources = [maker(r) for r in ratios]
            ref_nf = getattr(ref_sources[i], "num_frames", None)
            if ref_nf is not None and sub_sources[0].num_frames:
                sub_sources.append(maker(float(ref_nf) / sub_sources[0].num_frames))
            sig = ref_sources[i].signal_or_spec()
            if not hasattr(sig, "padded_values"):
                # cue geometry (subtitle/PGS references) or a host signal
                sig = ref_sources[i].transform()
            if len(sig) == 0 or any(len(s.spec_.starts) == 0 for s in sub_sources):
                raise RuntimeError(
                    "cannot align empty speech data (reference length=%d); "
                    "the reference or subtitles may contain no detectable "
                    "speech" % len(sig)
                )
            refs.append(sig if hasattr(sig, "padded_values") else np.asarray(sig, np.float32))
            sources_per_job.append(sub_sources)
            makers_per_job.append(maker)
            live.append(i)
        except Exception as e:
            logger.exception("failed to prepare job %d", i)
            results[i]["error"] = str(e)

    if not live:
        return results

    # --- one batched search scores every job's candidate set ---------------
    aligner = BatchAligner(mesh)
    max_offset_samples = abs(int(max_offset_seconds * SAMPLE_RATE))
    all_alignments = aligner.align_batch(
        refs, [[s.spec_ for s in srcs] for srcs in sources_per_job],
        max_offset_samples=max_offset_samples,
    )

    if gss and not no_fix_framerate:
        # per round, ONE search scores all jobs' 33-ratio grids; each job
        # then narrows its own bracket around its argmax. The final round's
        # candidates join that job's selection pool, as the single-file gss
        # slot does.
        from ffsubsync_tpu_torch.sync import (
            GSS_TOL,
            MAX_FRAMERATE_RATIO,
            MIN_FRAMERATE_RATIO,
            gss_grid,
            gss_narrow,
        )

        brackets = [(MIN_FRAMERATE_RATIO, MAX_FRAMERATE_RATIO)] * len(live)
        while True:
            grids = [gss_grid(lo, hi) for lo, hi in brackets]
            steps = [step for step, _ratios in grids]
            round_ratios = [grid_ratios for _step, grid_ratios in grids]
            round_sources = [
                [makers_per_job[j](r) for r in grid_ratios]
                for j, grid_ratios in enumerate(round_ratios)
            ]
            round_aligns = aligner.align_batch(
                refs,
                [[s.spec_ for s in srcs] for srcs in round_sources],
                max_offset_samples=max_offset_samples,
            )
            if max(steps) <= GSS_TOL:
                for j in range(len(live)):
                    all_alignments[j] = list(all_alignments[j]) + list(round_aligns[j])
                    sources_per_job[j] = list(sources_per_job[j]) + list(round_sources[j])
                break
            brackets = [
                gss_narrow(
                    round_ratios[j], steps[j],
                    int(np.argmax([a.score for a in round_aligns[j]])),
                )
                for j in range(len(live))
            ]

    # --- per-job selection + output ----------------------------------------
    for j, i in enumerate(live):
        try:
            eligible = [
                (a, s)
                for a, s in zip(all_alignments[j], sources_per_job[j])
                if abs(a.offset) <= max_offset_samples
            ]
            if not eligible:
                raise RuntimeError("no alignment within +/-%s s" % max_offset_seconds)
            best, best_source = max(eligible, key=lambda x: x[0].score)
            offset_seconds = best.offset / float(SAMPLE_RATE)
            out_subs = shift_document(best_source.scaled_doc_, offset_seconds)
            srtout = jobs[i][2]
            if output_encoding != "same":
                out_subs = out_subs.set_encoding(output_encoding)
            out_subs.write_file(srtout)
            # flag (but still write) syncs the single-file quality gate would
            # reject, so "re-run ffs on the stragglers" is actionable
            quality_reasons = assess_alignment_quality(
                best.score,
                offset_seconds,
                best_source.scale_factor,
                min_score=min_score,
                max_offset_seconds=quality_max_offset_seconds,
                max_framerate_deviation=max_framerate_deviation,
            )
            results[i].update(
                offset_seconds=offset_seconds,
                framerate_scale_factor=best_source.scale_factor,
                sync_was_successful=not quality_reasons,
                quality_reasons=quality_reasons,
            )
            logger.info(
                "job %d: offset %.3f s scale %.3f score %.0f -> %s%s",
                i, offset_seconds, best_source.scale_factor, best.score, srtout,
                " [LOW QUALITY: %s]" % "; ".join(quality_reasons) if quality_reasons else "",
            )
        except Exception as e:
            logger.exception("failed to finish job %d", i)
            results[i]["error"] = str(e)
    return results


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Batch-synchronize many subtitle/reference pairs in one "
        "batched search over the local devices of the kind FFS_TORCH_DEVICE "
        "names."
    )
    parser.add_argument(
        "manifest",
        help="TSV manifest: one job per line, reference<TAB>srtin[<TAB>srtout]"
        " (default srtout: <srtin stem>.synced.srt)",
    )
    parser.add_argument("--vad", default=DEFAULT_VAD)
    parser.add_argument("--frame-rate", type=int, default=DEFAULT_FRAME_RATE)
    parser.add_argument("--max-offset-seconds", type=float, default=DEFAULT_MAX_OFFSET_SECONDS)
    parser.add_argument("--no-fix-framerate", action="store_true")
    parser.add_argument("--decode-workers", type=int, default=4)
    parser.add_argument(
        "--gss",
        action="store_true",
        help="Refine each job's framerate ratio with batched grid "
        "refinement (one search per round scores every job's ratio grid).",
    )
    parser.add_argument(
        "--output-encoding",
        default="utf-8",
        help="Output character encoding ('same' preserves each input's "
        "detected encoding; single-file semantics).",
    )
    parser.add_argument("--min-score", type=float, default=DEFAULT_MIN_SCORE)
    parser.add_argument(
        "--quality-max-offset-seconds", type=float, default=DEFAULT_QUALITY_MAX_OFFSET_SECONDS
    )
    parser.add_argument(
        "--max-framerate-deviation", type=float, default=DEFAULT_MAX_FRAMERATE_DEVIATION
    )
    parser.add_argument(
        "--pgs-ref-stream",
        default=None,
        help="Treat the references as PGS subtitle streams "
        "('auto' or a stream specifier, as in the single-file flag).",
    )
    parser.add_argument(
        "--reference-stream",
        default=None,
        help="Audio/subtitle stream to use from each reference.",
    )
    parser.add_argument("--multi-segment-sync", action="store_true")
    parser.add_argument("--segment-count", type=int, default=8)
    parser.add_argument("--start-seconds", type=int, default=0)
    parser.add_argument("--max-duration-seconds", type=float, default=None)
    args = parser.parse_args()
    jobs: List[Tuple[str, str, str]] = []
    with open(args.manifest) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 2 or len(parts) > 3:
                parser.error(
                    "%s:%d: expected reference<TAB>srtin[<TAB>srtout], got %r"
                    % (args.manifest, lineno, line)
                )
            if len(parts) == 2:
                parts.append(os.path.splitext(parts[1])[0] + ".synced.srt")
            jobs.append((parts[0], parts[1], parts[2]))
    results = sync_batch(
        jobs,
        vad=args.vad,
        frame_rate=args.frame_rate,
        max_offset_seconds=args.max_offset_seconds,
        no_fix_framerate=args.no_fix_framerate,
        gss=args.gss,
        decode_workers=args.decode_workers,
        output_encoding=args.output_encoding,
        min_score=args.min_score,
        quality_max_offset_seconds=args.quality_max_offset_seconds,
        max_framerate_deviation=args.max_framerate_deviation,
        ref_options={
            "pgs_ref_stream": args.pgs_ref_stream,
            "reference_stream": args.reference_stream,
            "multi_segment_sync": args.multi_segment_sync,
            "segment_count": args.segment_count,
            "start_seconds": args.start_seconds,
            "max_duration_seconds": args.max_duration_seconds,
        },
    )
    failed = [r for r in results if r["error"] or not r["sync_was_successful"]]
    for r in results:
        if r["sync_was_successful"]:
            status = "OK"
        elif r["error"]:
            status = r["error"]
        else:
            status = "LOW QUALITY: " + "; ".join(r["quality_reasons"])
        print("%s\t%s\t%s" % (r["srtin"], r["offset_seconds"], status))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
