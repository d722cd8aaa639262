# -*- coding: utf-8 -*-
"""What to run, found by name: ``BENCHMARK.json`` at the repository's root,
``configs/<config>.json``, ``traffic/<traffic>.json`` (the mix: the
entry kind, its flags and the generator's parameters),
``workloads/<cell>.json`` (the check's sample and limits),
``entries/<kind>.py`` and ``metrics/<metric>.py`` under the benchmark's
folder. Adding a cell, a configuration or a metric adds files and entries;
no file here changes."""
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def config(name):
    return load_json(os.path.join(BENCH_DIR, "configs", name + ".json"))


def workload(name):
    return load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))


def traffic(name):
    return load_json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def _load_module(kind, name):
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_%s_%s" % (kind, name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(kind):
    """The module that drives an entry kind (``entries/<kind>.py``)."""
    return _load_module("entries", kind)


def metric_reader(name):
    """The reader of one per-layer metric (``metrics/<name>.py``): its
    ``read(run)`` returns a number, or None where there is nothing to read."""
    return _load_module("metrics", name)


def cell_metrics(bench, cell, section):
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without ``workloads`` and those naming it."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def cell(name):
    """(BENCHMARK.json's entry, the workload file, its config file, its
    traffic file) of a cell; raises KeyError for a name BENCHMARK.json does
    not list."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    e = entries[name]
    return e, workload(name), config(e["config"]), traffic(e["traffic"])
