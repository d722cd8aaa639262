# -*- coding: utf-8 -*-
"""Milliseconds per request outside every recorded layer span: the request's
wall time less the union of its read, stage, VAD and search spans over all
threads (subtitle parse, rasters, the quality gate, the write, Python)."""


def _covered(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read(run):
    if not run.requests:
        return None
    by_request = {}
    for _layer, k, _tid, t0, t1 in run.spans:
        by_request.setdefault(k, []).append((t0, t1))
    rest = [(r["t1"] - r["t0"]) - _covered(by_request.get(r["k"], [])) for r in run.requests]
    return 1e3 * sum(rest) / len(rest)
