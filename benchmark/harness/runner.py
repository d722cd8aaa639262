# -*- coding: utf-8 -*-
"""One run of one cell: set up, warm up, measure for ``--seconds`` in a
closed loop with one client, check the answers, print the result line.

Nothing here falls back to the CPU: a run without the cards a cell asks
for exits with an error and prints no result. (The CPU tests drive the
same path on the CPU through ``run(..., require_cuda=False)``.)
"""
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from benchmark.harness import spec

# top-level module names the measured process must not hold: JAX and the
# JAX package this port was made from (compared whole: the port's own name
# begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ffsubsync_tpu")


def log(msg):
    sys.stderr.write("[bench] %s\n" % msg)
    sys.stderr.flush()


def forbidden_modules(modules=None):
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def sampled(k, seed, every):
    """Whether the check samples request ``k``: one in ``every``, at a
    phase drawn from the seed."""
    return k % every == np.random.default_rng([seed, 1]).integers(every)


class Context:
    """What an entry's ``request`` reads: the media, the traffic, where to
    write."""

    def __init__(self, media, traffic, outdir):
        self.media, self.traffic, self.outdir = media, traffic, outdir


class Run:
    """What a metric's reader reads (``metrics/<name>.py``): the requests
    of the window, the spans and VAD programs the recorder kept, the launch
    counters over the window, the trace (or None), the cell's config and
    traffic files and the window's seconds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def spans_of(self, layer):
        return [s for s in self.spans if s[0] == layer]


def _process_age():
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class ProgramOutput:
    """Sends the process's standard output and error to a file while the
    program runs: its log lines and progress bars land there, as those of a
    script that logs to a file do. A run's times then do not depend on how
    fast whoever started it drains a pipe. ``tail`` gives the end of it."""

    def __init__(self, path):
        self.path = path
        self.saved = None

    def __enter__(self):
        sys.stdout.flush()
        sys.stderr.flush()
        self.saved = (os.dup(1), os.dup(2))
        with open(self.path, "ab") as f:
            os.dup2(f.fileno(), 1)
            os.dup2(f.fileno(), 2)
        return self

    def __exit__(self, *exc):
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, saved in zip((1, 2), self.saved):
            os.dup2(saved, fd)
            os.close(saved)
        self.saved = None

    def tail(self, n):
        try:
            with open(self.path, "rb") as f:
                f.seek(max(0, os.path.getsize(self.path) - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""


def _device_info(torch, chips):
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


def run(workload, seed, seconds, traced, require_cuda=True, overrides=None, t0=None):
    """Run one cell; returns the result line's object (None when the run
    must print no result) and the exit code."""
    t_start = time.perf_counter() if t0 is None else t0
    age = _process_age()
    entry_spec, check_spec, config, traffic = spec.cell(workload)
    for part, extra in (overrides or {}).items():
        {"config": config, "traffic": traffic, "check": check_spec}[part].update(extra)
    bench = spec.benchmark()
    setup = {}

    import torch

    import ffsubsync_tpu_torch.sync  # noqa: F401  (the program under test)
    setup["import"] = time.perf_counter() - t_start + age
    chips = int(entry_spec["chips"])
    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        log("the cell needs %d CUDA device(s); found %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else "no CUDA"))
        return None, 2
    t = time.perf_counter()
    device = torch.device("cuda" if require_cuda else os.environ.get("FFS_TORCH_DEVICE", "cpu"))
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    setup["cuda_init"] = time.perf_counter() - t

    t = time.perf_counter()
    from ffsubsync_tpu_torch import native

    if not native.AVAILABLE:  # the host library, built and loaded once per checkout
        log("the host library did not build: staging runs in numpy")
    if device.type == "cuda":
        from ffsubsync_tpu_torch.ops import _build

        _build.load_library()  # the CUDA kernels, built once per checkout
    setup["kernel_load"] = time.perf_counter() - t

    from benchmark.harness import synth

    workdir = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    try:
        t = time.perf_counter()
        media = synth.make_media(workdir, seed, config, traffic, device)
        outdir = os.path.join(workdir, "out")
        os.makedirs(outdir)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup["inputs"] = time.perf_counter() - t

        entry = spec.entry(traffic["entry"])
        ctx = Context(media, traffic, outdir)
        output = ProgramOutput(os.path.join(workdir, "program.log"))
        try:
            with output:
                t = time.perf_counter()
                entry.request(ctx, -1)  # warm-up: this cell's shapes, once
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                setup["warm_up"] = time.perf_counter() - t
                setup_s = time.perf_counter() - t_start + age
                result = _measure(torch, device, entry, ctx, config, check_spec, seed, seconds,
                                  traced, workdir)
        finally:
            sys.stderr.write(output.tail(2000) + "\n")
        log("set-up %.3f s: " % setup_s + ", ".join(
            "%s %.3f s" % kv for kv in setup.items()))
        requests, rec, counters, trace, failed, attempted = result
        memory_peak = (int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0)
        bad = forbidden_modules()
        if bad:
            log("the measured process holds %s" % ", ".join(bad))
            return None, 3

        window_s = requests[-1]["t1"] - requests[0]["t0"] if requests else seconds
        walls = [r["t1"] - r["t0"] for r in requests]
        log("window %.3f s: %d requests, wall s min %.4f p10 %.4f median %.4f p90 %.4f max %.4f"
            % ((window_s, len(walls)) + tuple(np.percentile(walls, [0, 10, 50, 90, 100]))))
        hours = sum(r["hours"] for r in requests)
        measured = Run(requests=requests, spans=rec.spans, programs=rec.programs,
                       counters=counters, trace=trace, config=config, traffic=traffic,
                       window_s=window_s)
        if traced:
            metrics = {}
            for m in spec.cell_metrics(bench, workload, "per_layer"):
                value = spec.metric_reader(m["name"]).read(measured)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = {"film_h_per_s": hours / window_s,
                      "sync_p90_s": float(np.percentile(walls, 90)),
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in spec.cell_metrics(bench, workload, "end_to_end")}
        device_line = _device_info(torch, chips)
        device_line["memory_peak_bytes"] = memory_peak
        if traced:
            device_line["busy_s"] = trace.busy_s
            device_line["window_s"] = trace.window_s

        rec.searches = None  # the program's labels on the card: freed before the reference runs
        t = time.perf_counter()
        correct, table = _check(rec_jobs(requests), config, traffic, check_spec, device)
        log("check of %d syncs in %.1f s" % (len(rec_jobs(requests)), time.perf_counter() - t))
        line = {"correct": bool(correct and failed == 0), "attempted": attempted,
                "failed": failed, "metrics": metrics, "device": device_line}
        if traced:
            line["breakdown"] = trace.breakdown()
        line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()}
        for k, (v, lim) in table.items():
            log("check %s %r limit %r" % (k, v, lim))
        return line, 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def rec_jobs(requests):
    return [job for r in requests for job in r["jobs"] if "labels" in job]


def _measure(torch, device, entry, ctx, config, check_spec, seed, seconds, traced, workdir):
    """Drive ``entry`` for ``seconds`` in a closed loop (under the profiler
    where ``traced``). Returns (requests, recorder, launch counters over the
    window, trace or None, failed jobs, attempted jobs)."""
    from benchmark.harness import spans as spans_mod

    hours_per_job = config["minutes"] / 60.0
    every = int(check_spec["sample_every"])
    requests, failed, attempted = [], 0, 0
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    rec = spans_mod.Recorder()
    with rec:
        before = spans_mod.counters()
        window = torch.profiler.record_function("bench.window") if traced else None
        t_begin = time.perf_counter()
        if window is not None:
            window.__enter__()
        k = 0
        while time.perf_counter() - t_begin < seconds:
            rec.begin(k, bool(sampled(k, seed, every)))
            t0 = time.perf_counter()
            jobs = entry.request(ctx, k)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec.end()
            attempted += len(jobs)
            failed += sum(not j["ok"] for j in jobs)
            requests.append({"k": k, "t0": t0, "t1": t1, "jobs": jobs,
                             "hours": hours_per_job * sum(j["ok"] for j in jobs)})
            k += 1
        if window is not None:
            window.__exit__(None, None, None)
        after = spans_mod.counters()
    trace = None
    if traced:
        prof.__exit__(None, None, None)
        from benchmark.harness.trace import Trace

        t = time.perf_counter()
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        size = os.path.getsize(path)
        main = threading.get_native_id()
        spans = [(layer, tid, a, b) for layer, _k, tid, a, b in rec.spans]
        spans += [("request", main, r["t0"], r["t1"]) for r in requests]
        trace = Trace.from_file(path, spans, t_begin)
        os.remove(path)
        log("trace: %.1f MB, %d kernels, read in %.1f s"
            % (size / 1e6, len(trace.kernels), time.perf_counter() - t))
    counters = {k: after[k] - before[k] for k in after}
    _attach(requests, rec, seed, check_spec)
    return requests, rec, counters, trace, failed, attempted


def _attach(requests, rec, seed, check_spec):
    """Give each sampled job its labels, score and written cues, taken from
    what the program handed its search and wrote."""
    from benchmark.harness.check import written_ms
    from benchmark.reference.search import RATIOS

    per_request = int(check_spec.get("jobs_per_request", 0))
    for r in requests:
        searches = rec.searches.get(r["k"])
        if not searches or searches[0][0] is None:
            continue
        refs, _cands, outs = searches[0]
        jobs = r["jobs"]
        pick = range(len(jobs))
        if per_request and per_request < len(jobs):
            pick = np.random.default_rng([seed, 2, r["k"]]).choice(
                len(jobs), per_request, replace=False)
        for e in pick:
            job = jobs[int(e)]
            job["labels"] = None
            if not job["ok"] or len(refs) != len(jobs) or job["ratio"] not in RATIOS:
                continue
            job["labels"] = np.asarray(refs[int(e)], np.float64)
            job["score"] = outs[int(e)][RATIOS.index(job["ratio"])].score
            job["written"] = written_ms(job["out"])


def _check(jobs, config, traffic, check_spec, device):
    from benchmark.harness.check import Judge, verdict

    judge = Judge(_weights(config), traffic, device)
    numbers = [judge.judge(j) for j in jobs if j["labels"] is not None]
    return verdict(numbers, check_spec["limits"], len(jobs))


def _weights(config):
    config = dict(config)
    if config.get("weights"):
        config["weights"] = os.path.join(spec.ROOT, config["weights"])
    return config


def print_result(line):
    sys.stdout.write(json.dumps(line, allow_nan=False, default=float) + "\n")
    sys.stdout.flush()


def main(argv=None, t0=None):
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    line, rc = run(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    if line is None:
        return rc or 1
    line["check"] = {k: {kk: (vv if math.isfinite(vv) else str(vv)) for kk, vv in v.items()}
                     for k, v in line["check"].items()}
    print_result(line)
    return 0
