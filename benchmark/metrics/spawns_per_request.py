# -*- coding: utf-8 -*-
"""Process spawns per request (span ``spawn``: each subprocess.Popen or call of
ffmpeg or ffprobe in media/ and sync.extract_subtitles_from_reference,
failed ones included)."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.count("spawn")
