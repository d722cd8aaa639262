# -*- coding: utf-8 -*-
"""The comparison that decides ``correct``.

Each sampled sync is judged by four numbers, each against the cell's
limit (``workloads/<cell>.json``); but for ``flip_share`` each is the
largest over the sample:

- ``flip_share``: the share of 10 ms windows whose label differs from the
  plain reference's by more than 0.2 (a hard decision of the detector
  flipped), over all the windows of the sampled syncs together: a flipped
  vote changes a whole run of windows (its 8-window hangover and 26-window
  pre-hangover), so one film's share swings with a single vote;
- ``soft_gap``: the largest label difference on the other windows (the
  net's probabilities; cells whose labels are all hard read 0);
- ``search_gap``: on the program's own labels, how far the program's
  answer (ratio, offset) lies below the best that the float64 search finds,
  or how far the score it reported lies from that answer's exact score,
  as a share of the best score;
- ``cue_ms``: the largest distance in ms between a cue of the written file
  and the input cue shifted and scaled by the program's answer in exact
  arithmetic.

The reference labels of each film are computed once per process and
shared by the sampled syncs of that film.
"""
import math

import numpy as np

from benchmark.reference import pipeline, search

FLIP = 0.2


def label_numbers(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return {"flips": math.inf, "windows": max(1, want.size), "soft_gap": math.inf}
    d = np.abs(got - want)
    flips = d > FLIP
    soft = d[~flips]
    return {"flips": int(flips.sum()), "windows": int(flips.size),
            "soft_gap": float(soft.max()) if soft.size else 0.0}


def search_numbers(labels, cues_us, ratio, offset_s, score, max_offset, device):
    """``search_gap`` of an answer on ``labels``; inf for an answer outside
    the candidates or the offset bound."""
    if ratio not in search.RATIOS or offset_s is None:
        return {"search_gap": math.inf}
    s = search.Search(labels, cues_us, max_offset, device)
    i = search.RATIOS.index(ratio)
    off = int(round(offset_s * search.RATE))
    if abs(off) > max_offset:
        return {"search_gap": math.inf}
    best, exact = s.best_score(), s.exact(i, off)
    return {"search_gap": max(best - exact, abs(score - exact)) / abs(best)}


def cue_numbers(written_ms, cues_us, ratio, offset_s):
    want = search.shifted_ms(cues_us, ratio, offset_s)
    if len(written_ms) != len(want):
        return {"cue_ms": math.inf}
    return {"cue_ms": float(max(max(abs(a - c), abs(b - d))
                                for (a, b), (c, d) in zip(written_ms, want)))}


def written_ms(path):
    return [(a // 1000, b // 1000) for a, b in search.read_srt_us(path)]


class Judge:
    """Judges sampled syncs of one cell against the plain reference."""

    def __init__(self, config, traffic, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.max_offset = int(traffic["max_offset_seconds"] * search.RATE)
        self._labels = {}

    def reference_labels(self, wav, precision="float64"):
        key = (wav, precision)
        if key not in self._labels:
            t = self.traffic
            weights = self.config.get("weights")
            self._labels[key] = pipeline.labels(
                wav, t["vad_mode"], self.config["pipeline_chunk_seconds"], precision,
                self.device, weights)
        return self._labels[key]

    def judge(self, job):
        """The numbers of one sync: ``job`` holds the files it read and
        wrote, its answer (``ratio``, ``offset_s``, ``score``) and its
        ``labels``."""
        cues = search.read_srt_us(job["srt"])
        out = dict(label_numbers(job["labels"], self.reference_labels(job["wav"])))
        out.update(search_numbers(job["labels"], cues, job["ratio"], job["offset_s"],
                                  job["score"], self.max_offset, self.device))
        out.update(cue_numbers(job["written"], cues, job["ratio"], job["offset_s"])
                   if job["ratio"] in search.RATIOS else {"cue_ms": math.inf})
        return out

    def control(self, job):
        """The same numbers for the control: the reference in the
        program's place at the precision below the stated one (TF32
        products in the frontend and the net; the frontend's outputs, the
        detector's arrays and the net's activations kept in bfloat16; a
        bfloat16 search; float32 cue arithmetic), on the job's own files."""
        cues = search.read_srt_us(job["srt"])
        labels = self.reference_labels(job["wav"], "control")
        i, off, score = search.Search(labels, cues, self.max_offset, self.device, "bf16").pick()
        ratio, offset_s = search.RATIOS[i], off / float(search.RATE)
        out = dict(label_numbers(labels, self.reference_labels(job["wav"])))
        out.update(search_numbers(labels, cues, ratio, offset_s, score, self.max_offset,
                                  self.device))
        out.update(cue_numbers(search.shifted_ms_float32(cues, ratio, offset_s), cues, ratio,
                               offset_s))
        return out


def summary(numbers_per_job):
    """The sample's readings: ``flip_share`` over all its windows, every
    other number the largest of its jobs'."""
    if not numbers_per_job:
        return {}
    out = {k: max(n[k] for n in numbers_per_job)
           for k in numbers_per_job[0] if k not in ("flips", "windows")}
    out["flip_share"] = (sum(n["flips"] for n in numbers_per_job)
                         / sum(n["windows"] for n in numbers_per_job))
    return out


def verdict(numbers_per_job, limits, expected_jobs):
    """(correct, {number: [reading, limit]}) over the judged jobs."""
    readings = summary(numbers_per_job)
    table = {name: [readings.get(name, math.inf), limit] for name, limit in limits.items()}
    correct = (len(numbers_per_job) == expected_jobs and expected_jobs > 0
               and all(v <= lim for v, lim in table.values()))
    return correct, table
