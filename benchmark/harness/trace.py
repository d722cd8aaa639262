# -*- coding: utf-8 -*-
"""Reduction of a ``torch.profiler`` Chrome trace of the measured window.

Device operations are the trace's kernels, copies and sets. The host's
layers are the recorder's spans (every thread's), placed on the trace's
clock by the window's one ``bench.window`` range, which the measuring
thread opens right after it reads the host clock. Each kernel is put in
the layer whose span was innermost on the thread that launched it (found
through the launch's correlation id), and each stretch of the window in
which no device operation runs in the layer innermost on any thread at its
middle: ``sync_rest`` where only the request itself was open,
``between_requests`` where not even that.
"""
import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
REQUEST = "request"


def _label(name):
    if name is None:
        return "between_requests"
    if name == REQUEST:
        return "sync_rest"
    return name


class _Ranges:
    """The host's spans, (thread, start, end, layer) in trace microseconds,
    to find the innermost open at a time."""

    def __init__(self, spans):
        self.by_tid = {}
        for tid, a, b, layer in spans:
            self.by_tid.setdefault(tid, []).append((a, b, layer))
        for v in self.by_tid.values():
            v.sort()
        self.starts = {tid: [r[0] for r in v] for tid, v in self.by_tid.items()}
        self.all = sorted(r for v in self.by_tid.values() for r in v)
        self.all_starts = [r[0] for r in self.all]
        self.longest = max((b - a for a, b, _n in self.all), default=0.0)

    def _latest_open(self, ranges, starts, t):
        """The range of ``ranges`` (sorted by start) that began last among
        those open at ``t``: the innermost, as ranges nest or follow."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t - ranges[i][0] <= self.longest:
            if ranges[i][1] > t:
                return ranges[i]
            i -= 1
        return None

    def innermost(self, tid, t):
        """(start, end, name) of the innermost range open at ``t`` on
        ``tid``."""
        return self._latest_open(self.by_tid.get(tid, []), self.starts.get(tid, []), t)

    def innermost_any(self, t):
        """The same on any thread."""
        return self._latest_open(self.all, self.all_starts, t)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What the window's trace holds: ``window_s``, ``busy_s``,
    ``kernels`` [(name, seconds, layer)], ``idle`` {layer: seconds},
    ``device_ops`` [[name, seconds]] (the ten that took most time)."""

    def __init__(self, events, spans, window_start):
        """``spans``: (layer, thread, start, end) on the host clock in
        seconds, ``window_start`` the host clock when the window's range
        opened."""
        windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"]  # not its copy on the card's row
        if len(windows) != 1:
            raise ValueError("the trace holds %d measured windows" % len(windows))
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        shift = w0 - window_start * 1e6
        ranges = _Ranges([(tid, a * 1e6 + shift, b * 1e6 + shift, layer)
                          for layer, tid, a, b in spans])
        launches = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
        device = []
        self.kernels = []
        by_name = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if b <= w0 or a >= w1:
                continue
            device.append((max(a, w0), min(b, w1)))
            name = str(e.get("name", ""))
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
            if e["cat"] == "kernel":
                launch = launches.get(e.get("args", {}).get("correlation"))
                hit = None
                if launch and launch[0] in ranges.by_tid:
                    hit = ranges.innermost(*launch)
                elif launch:  # a thread the recorder never saw: go by time
                    hit = ranges.innermost_any(launch[1])
                self.kernels.append((name, (b - a) * 1e-6, _label(hit[2] if hit else None)))
        busy = _union(device)
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.idle = {}
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                hit = ranges.innermost_any((a + b) / 2)
                label = _label(hit[2] if hit else None)
                self.idle[label] = self.idle.get(label, 0.0) + (b - a) * 1e-6
        self.device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10]

    @classmethod
    def from_file(cls, path, spans, window_start):
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []), spans, window_start)

    def kernel_seconds(self, fragment=None, layer=None):
        """(summed seconds, events) of the kernels whose name holds
        ``fragment`` and that ran in ``layer``."""
        hits = [s for n, s, lay in self.kernels
                if (fragment is None or fragment in n) and (layer is None or lay == layer)]
        return sum(hits), len(hits)

    def breakdown(self):
        idle = sorted(([k, v] for k, v in self.idle.items()), key=lambda x: -x[1])[:10]
        return {"device_ops": self.device_ops, "idle_gaps": idle}
