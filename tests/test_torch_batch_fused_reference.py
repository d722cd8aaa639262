# -*- coding: utf-8 -*-
"""``sync_batch(vad="fused")`` against the benchmark's plain reference, on
seeded random net weights.

Three jobs over two 130-s WAVs at 12 kHz, in 25-s pipeline chunks so that
the detectors carry their state (the webrtc bands' and the net's context)
across six chunks. The media layer dispatches whole reads of 100 s
(``media/audio.WINDOWS_PER_BUFFER``) and splits each at the pipeline chunk,
so a chunk that does not divide the read (30 s: 30, 30, 30, 10, 30) cuts
the signal elsewhere than the reference's even chunks do and changes the
net's per-chunk normalization; the shipped 2700 s is 27 reads, and 25 s a
quarter of one. The net's weights are drawn by ``init_params`` from a
seeded generator and written to one ``.npz`` that both sides load: the
port through ``neural_vad.default_weights_path``, the reference
(``benchmark/reference``, plain float64 PyTorch that imports nothing of
the port) through ``net.load_weights``. The labels each job hands its
search are taken as the benchmark's recorder takes them.
"""
import numpy as np
import pytest
import torch

from benchmark.harness.spans import Recorder
from benchmark.reference import pipeline, search
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.models import neural_vad
from ffsubsync_tpu_torch.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch.utils.fixtures import write_wav_i16

torch.set_num_threads(1)

RATE = 12000
SECONDS = 130.0
CHUNK_S = 25
MAX_OFFSET = 60 * search.RATE  # sync_batch's default bound, in 100-Hz samples
SEEDS = (0, 4)  # nets whose probabilities spread over (0, 1); seeds 2, 3 and 7 saturate
# (film, offset s, framerate ratio the subtitles were scaled by)
JOBS = ((0, 3.37, 1.0), (1, -4.81, 25.0 / 24.0), (0, 11.02, 1.0))


def _spans(rng):
    spans, t = [], 8.0 + rng.uniform(0, 2)  # no cue moves before 0 s
    while True:
        length = rng.uniform(1.0, 4.0)
        if t + length > SECONDS - 6:
            return spans
        spans.append((t, t + length))
        t += length + rng.uniform(0.8, 4.0)


def _srt(spans, offset, ratio):
    def ts(t):
        ms = int(round(t * 1000))
        return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60,
                                        ms % 1000)

    return "".join("%d\n%s --> %s\nline %d\n\n" % (i + 1, ts(a * ratio + offset),
                                                   ts(b * ratio + offset), i)
                   for i, (a, b) in enumerate(spans))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_batch")
    rng = np.random.RandomState(5)
    films = []
    for f in range(2):
        spans = _spans(rng)
        wav = str(d / ("film%d.wav" % f))
        write_wav_i16(wav, speech_signal_for_spans(SECONDS, spans, RATE, seed=f,
                                                   speech_level=0.35), RATE)
        films.append((wav, spans))
    jobs = []
    for j, (f, offset, ratio) in enumerate(JOBS):
        srt = d / ("in%d.srt" % j)
        srt.write_text(_srt(films[f][1], offset, ratio))
        jobs.append((films[f][0], str(srt)))
    return {"dir": d, "jobs": jobs}


@pytest.fixture(scope="module")
def runs(media):
    """{(seed, decode workers): (labels per job, answers, weights path,
    written files)}, each batch run once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_TORCH_DEVICE", "cpu")
        mp.setenv("FFS_TPU_PIPELINE_SECONDS", str(CHUNK_S))
        for seed in SEEDS:
            weights = str(media["dir"] / ("net%d.npz" % seed))
            params = neural_vad.init_params(torch.Generator().manual_seed(seed))
            np.savez(weights, **{k: v.numpy() for k, v in params.items()})
            mp.setattr(neural_vad, "default_weights_path", lambda rate=None, w=weights: w)
            for workers in (1, 4):
                outs = [str(media["dir"] / ("out%d_%d_%d.srt" % (seed, workers, j)))
                        for j in range(len(JOBS))]
                jobs = [(wav, srt, o) for (wav, srt), o in zip(media["jobs"], outs)]
                with Recorder() as rec:
                    rec.begin(0, True)
                    results = sync_batch(jobs, vad="fused", decode_workers=workers)
                    rec.end()
                (refs, _candidates, alignments), = rec.searches[0]
                labels = [np.asarray(r, np.float64) for r in refs]
                answers = []
                for r, a in zip(results, alignments):
                    assert r["error"] is None, r
                    ratio = r["framerate_scale_factor"]
                    answers.append((ratio, r["offset_seconds"],
                                    a[search.RATIOS.index(ratio)].score))
                out[seed, workers] = (labels, answers, weights, outs)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_the_labels_match_the_plain_reference(runs, media, seed):
    """No hard decision flips (a label more than 0.2 from the reference's:
    the webrtc vote weighs 0.4 in the fusion) and the rest within 2e-3, the
    bounds of ``benchmark/tests/test_bench_reference.py``: the port's
    float32 net and frontend against the float64 reference differ by the
    rounding of log-mel channels at the log floor, which the per-chunk
    normalization divides by a std near 1e-3."""
    labels, _answers, weights, _outs = runs[seed, 4]
    for (wav, _srt), got in zip(media["jobs"], labels):
        want = pipeline.labels(wav, "weighted", CHUNK_S, "float64", torch.device("cpu"),
                               weights)
        assert got.shape == want.shape == (int(SECONDS * search.RATE),)
        d = np.abs(got - want)
        assert int((d > 0.2).sum()) == 0
        assert d.max() <= 2e-3, d.max()
        assert np.ptp(got) >= 0.4  # the webrtc votes move (a random net may saturate)


@pytest.mark.parametrize("seed", SEEDS)
def test_each_answer_is_the_reference_search_best_and_the_cues_exact(runs, media, seed):
    labels, answers, _weights, outs = runs[seed, 4]
    # a random net is a poor detector: the best answer need not be the
    # planted one, only the same on both sides
    for (_wav, srt), got, (ratio, offset_s, score), out in zip(
            media["jobs"], labels, answers, outs):
        cues = search.read_srt_us(srt)
        s = search.Search(got, cues, MAX_OFFSET, torch.device("cpu"))
        i, off, _best = s.pick()
        assert (ratio, round(offset_s * search.RATE)) == (search.RATIOS[i], off)
        exact = s.exact(i, off)
        assert abs(score - exact) <= 1e-6 * abs(exact)
        written = [(a // 1000, b // 1000) for a, b in search.read_srt_us(out)]
        assert written == search.shifted_ms(cues, ratio, offset_s)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_and_four_decode_workers_agree_bit_for_bit(runs, seed):
    one, four = runs[seed, 1], runs[seed, 4]
    for a, b in zip(one[0], four[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert one[1] == four[1]
    for a, b in zip(one[3], four[3]):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
