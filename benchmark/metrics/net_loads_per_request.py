# -*- coding: utf-8 -*-
"""Loads of the neural VAD per request (span ``net_load``:
models/neural_vad.load_net, the shipped weights read and the net moved to
the device; one per fused detector built, so one per film today)."""
from benchmark.harness import program_spans


def read(run):
    spans = program_spans.of(run)
    return None if spans is None else spans.count("net_load")
