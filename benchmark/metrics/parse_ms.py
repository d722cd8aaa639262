# -*- coding: utf-8 -*-
"""Host milliseconds per request parsing subtitle files (span ``parse``:
subs/parser.SubtitleParser.fit when it reads and parses, not on a cache
hit), summed over threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("parse")
