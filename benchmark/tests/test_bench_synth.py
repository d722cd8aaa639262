# -*- coding: utf-8 -*-
"""The generator: the same seed gives the same files, another seed other
ones of the same sizes, and each request's subtitles are the film's spans
at the ratio and offset its plan drew."""
import hashlib
import os

import numpy as np
import pytest
import torch

from benchmark.harness import spec, synth
from benchmark.reference.search import read_srt_us
from benchmark.tests.conftest import tiny

SEEDS = (3, 2**31 + 5, 2**40 + 1)


def _media(tmp_path, seed, cell="film90-default"):
    _e, _check, config, traffic = spec.cell(cell)
    ov = tiny(cell)
    config.update(ov["config"])
    traffic.update(ov["traffic"])
    d = tmp_path / str(seed)
    d.mkdir()
    return synth.make_media(str(d), seed, config, traffic, torch.device("cpu")), config, traffic


def _digest(media):
    h = hashlib.sha256()
    for p in media.wavs + media.srt_paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_same_seed_same_files(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    a = _media(tmp_path / "a", SEEDS[1])[0]
    b = _media(tmp_path / "b", SEEDS[1])[0]
    assert _digest(a) == _digest(b)


def test_other_seeds_other_files_of_the_same_sizes(tmp_path):
    medias = [_media(tmp_path, s)[0] for s in SEEDS]
    assert len({_digest(m) for m in medias}) == len(SEEDS)
    for m in medias[1:]:
        assert [os.path.getsize(p) for p in m.wavs] == [os.path.getsize(p) for p in medias[0].wavs]
        assert [len(s) for s in m.spans] == [len(s) for s in medias[0].spans]


@pytest.mark.parametrize("seed", SEEDS)
def test_subtitles_hold_the_planned_ratio_and_offset(tmp_path, seed):
    media, config, traffic = _media(tmp_path, seed)
    assert len(media.plan) == traffic["subtitle_files"]
    scaled = [r for r, _o in media.plan if r != 1.0]
    assert len(scaled) == traffic["subtitle_files"] // traffic["scaled_every"]
    assert all(r in synth.FRAMERATE_RATIOS for r in scaled)
    for j, (ratio, offset) in enumerate(media.plan):
        assert abs(offset) <= traffic["offset_bound_seconds"]
        spans = media.spans[j % len(media.wavs)]
        cues = np.array(read_srt_us(media.srt_paths[j])) / 1e6
        want = np.array(spans) * ratio + offset
        assert cues.shape == want.shape and np.abs(cues - want).max() <= 0.0005 + 1e-9
        assert cues.min() >= 0


def test_spans_fill_the_film(tmp_path):
    media, config, traffic = _media(tmp_path, SEEDS[0])
    duration = config["minutes"] * 60.0
    for spans in media.spans:
        arr = np.array(spans)
        assert len(spans) == config["cues_per_film"]
        assert arr[0, 0] == pytest.approx(traffic["lead_seconds"])
        assert arr[-1, 1] == pytest.approx(duration - synth.TAIL_S)
        lengths = arr[:, 1] - arr[:, 0]
        assert lengths.min() >= synth.SPAN_S[0] and lengths.max() <= synth.SPAN_S[1]
        assert (arr[1:, 0] > arr[:-1, 1]).all()


def test_speech_lies_in_the_spans(tmp_path):
    from benchmark.reference.pipeline import read_wav

    media, config, _t = _media(tmp_path, SEEDS[0])
    rate, pcm = read_wav(media.wavs[0])
    assert rate == config["analysis_rate_hz"] and len(pcm) == config["minutes"] * 60 * rate
    inside = np.zeros(len(pcm), bool)
    for a, b in media.spans[0]:
        inside[int(a * rate): int(b * rate)] = True
    x = pcm.astype(np.float64)
    assert np.sqrt(np.mean(x[inside] ** 2)) > 10 * np.sqrt(np.mean(x[~inside] ** 2))
