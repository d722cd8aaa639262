# -*- coding: utf-8 -*-
"""Host milliseconds per request writing the output (span ``write``:
shift_document, the encoding and write_file in sync.try_sync and
batch.sync_batch), summed over threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("write")
