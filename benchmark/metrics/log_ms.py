# -*- coding: utf-8 -*-
"""Host milliseconds per request in the records that the package's own log
handler renders and writes (span ``log``: ffsubsync_tpu_torch/__init__.py),
summed over threads. Records logged inside another span (the probe's) are
in that span's metric too."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("log")
