# -*- coding: utf-8 -*-
"""The program's own spans of the measured window, per request.

The port times its layers itself (``ffsubsync_tpu_torch.utils.tracing``):
each span is (name, id, parent id, request id, system thread id, t0, t1) on
the host clock that the window's requests are timed on. Tracing is on in a
traced run, because the runner's profiler records around the window, and
off in the others. Each root span (``sync``, ``batch``: the span that opened
its request id) goes to the request of ``run.requests`` whose [t0, t1] holds
it, and every span that carries the root's request id, on any thread, goes
with it. A span's self time is its duration less the union of its
children's intervals (children on any thread, clipped to the span).

A program without the tracing module, one that recorded no root span
inside a request, or one whose store dropped spans past its bound (a window
it did not keep whole), gives None, and its readers report nothing.
"""
import bisect

_MISSING = object()


def _covered(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _program_spans():
    try:
        from ffsubsync_tpu_torch.utils import tracing
    except ImportError:
        return None
    if tracing.counts().get("dropped", 0):
        return None
    return tracing.spans()


class Requests:
    """The spans of each request whose root the program recorded, by the
    request's ``k``; per-request means are over those requests."""

    def __init__(self, spans, requests):
        order = sorted(requests, key=lambda r: r["t0"])
        starts = [r["t0"] for r in order]
        request_of = {}  # the program's request id -> the window's request k
        for s in spans:
            if s.request != s.id:
                continue
            i = bisect.bisect_right(starts, s.t0) - 1
            if i >= 0 and order[i]["t0"] <= s.t0 and s.t1 <= order[i]["t1"]:
                request_of[s.request] = order[i]["k"]
        self.by_request = {k: [] for k in request_of.values()}
        for s in spans:
            k = request_of.get(s.request)
            if k is not None:
                self.by_request[k].append(s)

    def _mean(self, per_request):
        return sum(per_request(spans) for spans in self.by_request.values()) / len(
            self.by_request)

    def total_ms(self, name):
        """Host ms per request in spans named ``name``, summed over threads."""
        return 1e3 * self._mean(
            lambda spans: sum(s.t1 - s.t0 for s in spans if s.name == name))

    def self_ms(self, name=None):
        """Self ms per request of the spans named ``name`` (None: the roots)."""
        def per_request(spans):
            children = {}
            for s in spans:
                children.setdefault(s.parent, []).append(s)
            total = 0.0
            for s in spans:
                if (s.request == s.id) if name is None else (s.name == name):
                    inside = [(max(c.t0, s.t0), min(c.t1, s.t1))
                              for c in children.get(s.id, ()) if c.t1 > s.t0 and c.t0 < s.t1]
                    total += (s.t1 - s.t0) - _covered(inside)
            return total

        return 1e3 * self._mean(per_request)

    def count(self, name):
        """Spans named ``name`` per request."""
        return self._mean(lambda spans: sum(s.name == name for s in spans))


def of(run):
    """The window's program spans by request (kept on ``run`` for the other
    readers), or None where there is nothing to read."""
    got = getattr(run, "_program_spans", _MISSING)
    if got is _MISSING:
        spans = _program_spans() if run.requests else None
        got = Requests(spans, run.requests) if spans else None
        if got is not None and not got.by_request:
            got = None
        run._program_spans = got
    return got
