# -*- coding: utf-8 -*-
"""Host milliseconds per request building the VAD detector (span ``detector``:
ops/vad.make_detector and parallel/vad_shard.maybe_sharded_detector in
media/audio, the net's load included), summed over threads."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.total_ms("detector")
