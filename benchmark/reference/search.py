# -*- coding: utf-8 -*-
"""Plain subtitle handling and alignment search.

Subtitles: SRT cues read in whole milliseconds, scaled by a framerate
ratio in float seconds and rounded to microseconds (half to even), shifted
by the offset rounded to microseconds, written truncated to milliseconds.
Rasters at 100 Hz: ``int(last end * 100) + 2`` samples, each cue from
``round(start * 100)`` for ``round(duration * 100)`` samples, valued
``min(1 / ratio, 1)``.

Search: both signals mapped to +-1 (labels ``2 x - 1``, zero past their
ends) at FFT length ``next_pow2(len(ref) + longest candidate)``; for each
candidate ratio, the circular cross-correlation over the offsets in
``(-max, max]`` (a candidate's representable ones), the first maximum
over descending offsets and its exact dot product; the best candidate by
that score among those within the bound, first in ratio order.
``precision="float64"`` is the reference; ``"bf16"`` the control: both
signals and the rescored products rounded to bfloat16.
"""
import re

import numpy as np
import torch

RATE = 100
FRAMERATE_RATIOS = (24.0 / 23.976, 25.0 / 23.976, 25.0 / 24.0)
RATIOS = (1.0,) + FRAMERATE_RATIOS + tuple(1.0 / r for r in FRAMERATE_RATIOS)

_STAMP = re.compile(r"(\d+):(\d\d):(\d\d),(\d+)\s*-->\s*(\d+):(\d\d):(\d\d),(\d+)")


def read_srt_us(path):
    """[(start_us, end_us)] of every cue of an SRT file."""
    out = []
    with open(path, encoding="utf-8") as f:
        for m in _STAMP.finditer(f.read()):
            h1, m1, s1, ms1, h2, m2, s2, ms2 = (int(g) for g in m.groups())
            out.append((((h1 * 60 + m1) * 60 + s1) * 1000000 + ms1 * 1000,
                        ((h2 * 60 + m2) * 60 + s2) * 1000000 + ms2 * 1000))
    return out


def scaled_us(cues_us, ratio):
    return [(round(a / 1e6 * ratio * 1e6), round(b / 1e6 * ratio * 1e6)) for a, b in cues_us]


def shifted_ms(cues_us, ratio, offset_s):
    """The cues as the synced file must hold them, in whole ms."""
    delta = round(offset_s * 1e6)
    return [((a + delta) // 1000, (b + delta) // 1000) for a, b in scaled_us(cues_us, ratio)]


def shifted_ms_float32(cues_us, ratio, offset_s):
    """The same in float32 arithmetic: the control of the write."""
    f = np.float32
    return [(int(np.floor((f(a) / f(1e6) * f(ratio) + f(offset_s)) * f(1000))),
             int(np.floor((f(b) / f(1e6) * f(ratio) + f(offset_s)) * f(1000))))
            for a, b in cues_us]


def raster(cues_us, ratio):
    """(n_samples, starts, ends, weight) of the cues scaled by ``ratio``."""
    cues = scaled_us(cues_us, ratio)
    n = int(max(b for _a, b in cues) / 1e6 * RATE) + 2
    starts, ends = [], []
    for a, b in cues:
        s = int(round(a / 1e6 * RATE))
        e = s + int(round((b / 1e6 - a / 1e6) * RATE))
        # numpy's slice semantics: a negative index counts from the end
        s = min(max(s if s >= 0 else n + s, 0), n)
        e = min(max(e if e >= 0 else n + e, 0), n)
        starts.append(s)
        ends.append(max(s, e))
    return n, np.array(starts), np.array(ends), min(1.0 / ratio, 1.0)


def next_pow2(n):
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


def pm_candidate(r, n, dtype, device):
    n_samples, starts, ends, weight = r
    diff = np.zeros(n + 1)
    np.add.at(diff, starts, 1)
    np.add.at(diff, ends, -1)
    covered = np.cumsum(diff)[:n] > 0
    pm = np.where(covered, 2.0 * weight - 1.0, -1.0)
    pm[n_samples:] = 0.0
    return torch.from_numpy(pm).to(device=device, dtype=dtype)


def pm_labels(labels, n, dtype, device):
    pm = np.zeros(n)
    pm[: len(labels)] = 2.0 * np.asarray(labels, np.float64) - 1.0
    return torch.from_numpy(pm).to(device=device, dtype=dtype)


class Search:
    """The correlation of one reference's labels with every candidate
    ratio of one subtitle file."""

    def __init__(self, labels, cues_us, max_offset, device, precision="float64"):
        self.precision = precision
        self.rasters = [raster(cues_us, r) for r in RATIOS]
        self.n = next_pow2(len(labels) + max(r[0] for r in self.rasters))
        self.max_offset = max_offset
        dtype = torch.float64 if precision == "float64" else torch.float32
        self.ref = pm_labels(labels, self.n, dtype, device)
        self.subs = [pm_candidate(r, self.n, dtype, device) for r in self.rasters]
        if precision == "bf16":
            self.ref = self.ref.to(torch.bfloat16).to(dtype)
            self.subs = [s.to(torch.bfloat16).to(dtype) for s in self.subs]
        ref_f = torch.fft.rfft(self.ref)
        self.corr = [torch.fft.irfft(torch.conj(torch.fft.rfft(s)) * ref_f, n=self.n)
                     for s in self.subs]

    def offsets(self, i):
        """The allowed offsets of candidate ``i``, descending."""
        n_sub = self.rasters[i][0]
        hi = min(self.max_offset, self.n - 1 - n_sub)
        lo = max(-self.max_offset + 1, -n_sub)
        return hi - np.arange(max(hi - lo + 1, 1))

    def exact(self, i, offset):
        """The dot product of candidate ``i`` with the reference rolled by
        ``offset``."""
        prod = self.subs[i] * torch.roll(self.ref, -int(offset))
        if self.precision == "bf16":
            return float(prod.to(torch.bfloat16).sum())
        return float(prod.sum())

    def best_of(self, i):
        offs = self.offsets(i)
        c = self.corr[i][torch.from_numpy(np.mod(offs, self.n)).to(self.corr[i].device)]
        off = int(offs[int(torch.argmax(c))])
        return off, self.exact(i, off), float(c.max())

    def pick(self):
        """(candidate index, offset, score) of the search's answer."""
        best = None
        for i in range(len(RATIOS)):
            off, score, _ = self.best_of(i)
            if abs(off) <= self.max_offset and (best is None or score > best[2]):
                best = (i, off, score)
        return best

    def best_score(self):
        """The largest correlation over every candidate and allowed offset."""
        return max(self.best_of(i)[2] for i in range(len(RATIOS)))
