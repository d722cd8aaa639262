# -*- coding: utf-8 -*-
"""The port's batch sync against the JAX package's: the batched search
(``align_specs`` with a batch dimension) against ``_batched_sync_kernel``,
``BatchAligner`` on lazy and host references, the cases of
tests/test_batch.py, and WAV batches through ``sync_batch`` and the
``ffs-torch-batch`` CLI."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from ffsubsync_tpu.batch import sync_batch as jax_sync_batch
from ffsubsync_tpu.models.synth_data import speech_signal_for_spans
from ffsubsync_tpu_torch import batch as batch_mod
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.ops import align as talign
from ffsubsync_tpu_torch.ops.align import next_pow2
from ffsubsync_tpu_torch.ops.align_device import align_specs, prepare_ref_pm
from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal
from ffsubsync_tpu_torch.parallel.batch import BatchAligner
from ffsubsync_tpu_torch.subs.raster import rasterize_intervals

from tests.helpers import write_wav
from tests.test_batch import SPANS, _make_job, _srt, _ts

torch.set_num_threads(1)

CPU = torch.device("cpu")
SCORE_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _random_case(rng, b):
    """B soft references (host arrays, as fused labels are) with candidate
    sets of unequal sizes. Soft values keep exact-tie plateaus, whose pick
    f32 FFT rounding decides (ROADMAP C4), out of the comparison."""
    refs, cands = [], []
    for i in range(b):
        spans, t = [], 1.0 + rng.rand()
        for _ in range(rng.randint(3, 12)):
            length = rng.uniform(0.3, 2.0)
            spans.append((t, t + length))
            t += length + rng.uniform(0.3, 2.0)
        hard = np.asarray(rasterize_intervals(spans, 100).materialize())
        refs.append((hard * rng.uniform(0.6, 1.0, len(hard)) + 0.2 * rng.rand(len(hard)))
                    .astype(np.float32))
        cands.append([
            dataclasses.replace(
                rasterize_intervals(
                    [(max(0.0, (a - shift) * ratio), (e - shift) * ratio) for a, e in spans], 100
                ),
                weight=min(1.0 / ratio, 1.0),
            )
            for shift, ratio in zip(rng.uniform(-1.5, 1.5, rng.randint(1, 5)),
                                    (1.0, 1.04, 0.96, 1.001))
        ])
    return refs, cands


@pytest.mark.parametrize("max_offset", [None, 50, 300])
@pytest.mark.parametrize("seed", range(3))
def test_batched_search_equals_reference_kernel(seed, max_offset):
    import jax.numpy as jnp

    from ffsubsync_tpu.parallel.batch import _batched_sync_kernel

    refs, cands = _random_case(np.random.RandomState(seed), 4)
    n = next_pow2(max(len(r) for r in refs) + max(c.n_samples for cs in cands for c in cs))
    *arrays, n_offsets = talign.pack_candidates(cands, n, max_offset)
    ref_values = np.zeros((len(refs), n), np.float32)
    for i, r in enumerate(refs):
        ref_values[i, : len(r)] = r
    ref_lens = np.array([len(r) for r in refs], np.int32)
    want_s, want_o = _batched_sync_kernel(
        jnp.asarray(ref_values), jnp.asarray(ref_lens),
        *(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in arrays),
        n, n_offsets,
    )
    ref_pm = torch.stack([prepare_ref_pm(r, n, CPU) for r in refs])
    got_s, got_o = align_specs(ref_pm, *(torch.from_numpy(a) for a in arrays), n, n_offsets)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=SCORE_REL, atol=1e-3)


def test_batch_of_one_equals_single_search():
    refs, cands = _random_case(np.random.RandomState(7), 3)
    aligner = BatchAligner([CPU])
    batched = aligner.align_batch(refs, cands, max_offset_samples=200)
    for ref, cs, got in zip(refs, cands, batched):
        single = talign.align_candidates(ref, cs, 200, device=CPU)
        (alone,) = aligner.align_batch([ref], [cs], max_offset_samples=200)
        for s, g, a in zip(single, got, alone):
            assert s.offset == g.offset == a.offset
            assert g.score == pytest.approx(s.score, rel=SCORE_REL)
            assert a.score == pytest.approx(s.score, rel=SCORE_REL)


def test_batched_argmax_takes_the_first_maximum():
    """A plateau of exactly equal correlations per batch row: the largest
    allowed offset (the first gathered) wins in every row, as in the
    reference's descending-offset argmax."""
    n = 64
    ref_pm = torch.zeros((2, n))  # every offset scores exactly 0
    zeros = torch.zeros((2, 1, 1), dtype=torch.int64)
    scores, offsets = align_specs(
        ref_pm, zeros, zeros, torch.ones((2, 1)), torch.tensor([[8], [8]]),
        torch.tensor([[5], [3]]), torch.tensor([[10], [4]]), n, 10,
    )
    assert offsets.tolist() == [[5], [3]]
    assert scores.tolist() == [[0.0], [0.0]]


def test_batch_aligner_accepts_lazy_device_refs():
    """Port of tests/test_batch.py::test_batch_aligner_accepts_lazy_device_
    refs: lazy refs (two chunks each) score as their host values do."""
    rng = np.random.RandomState(0)
    aligner = BatchAligner([CPU])
    refs_np, refs_lazy, cands = [], [], []
    for b in range(3):
        spans, t = [], 1.0 + b
        for _ in range(10):
            ln = rng.uniform(0.5, 2.0)
            spans.append((t, t + ln))
            t += ln + rng.uniform(0.5, 2.0)
        sig = np.asarray(rasterize_intervals(spans, 100).materialize(), np.float32)
        refs_np.append(sig)
        half = len(sig) // 2
        refs_lazy.append(LazySpeechSignal([torch.from_numpy(sig[:half]), torch.from_numpy(sig[half:])]))
        shift = 0.5 * (b + 1)
        cands.append([rasterize_intervals([(a - shift, e - shift) for a, e in spans], 100)])
    out_np = aligner.align_batch(refs_np, cands, max_offset_samples=500)
    out_lazy = aligner.align_batch(refs_lazy, cands, max_offset_samples=500)
    mixed = aligner.align_batch([refs_lazy[0], refs_np[1], refs_lazy[2]], cands, 500)
    for b, (rn, rl, rm) in enumerate(zip(out_np, out_lazy, mixed)):
        assert rl[0].offset == rn[0].offset == rm[0].offset == int(0.5 * (b + 1) * 100)
        assert rl[0].score == pytest.approx(rn[0].score, rel=SCORE_REL)
        assert rm[0].score == pytest.approx(rn[0].score, rel=SCORE_REL)
    with pytest.raises(ValueError, match="candidate sets"):
        aligner.align_batch(refs_np, cands[:2])


def test_sync_batch_recovers_per_job_offsets(tmp_path):
    shifts = [3.0, -1.25, 0.75, 2.5]
    jobs = [_make_job(tmp_path, "j%d" % i, s, kind="npz" if i == 2 else "srt")
            for i, s in enumerate(shifts)]
    results = sync_batch(jobs)
    assert len(results) == len(jobs)
    for r, shift in zip(results, shifts):
        assert r["error"] is None
        assert r["sync_was_successful"]
        assert r["offset_seconds"] == pytest.approx(shift, abs=0.02)
        assert _ts(SPANS[0][0]).rsplit(",", 1)[0] in open(r["srtout"]).read()


def test_sync_batch_result_dicts_equal_reference(tmp_path):
    shifts = [3.0, -1.25, 0.75, -45.0]
    jobs = [_make_job(tmp_path, "e%d" % i, s, kind="npz" if i == 2 else "srt")
            for i, s in enumerate(shifts)]
    jobs.append((str(tmp_path / "missing_ref.srt"), jobs[0][1], str(tmp_path / "x.srt")))
    want = jax_sync_batch(jobs)
    outputs = [open(j[2]).read() for j in jobs[:-1]]
    got = sync_batch(jobs)
    assert [{k: v for k, v in r.items() if k != "error"} for r in got] == [
        {k: v for k, v in r.items() if k != "error"} for r in want
    ]
    assert [r["error"] is None for r in got] == [r["error"] is None for r in want]
    assert [open(j[2]).read() for j in jobs[:-1]] == outputs


def test_sync_batch_isolates_failing_jobs(tmp_path):
    good = _make_job(tmp_path, "ok", 1.0)
    bad = (str(tmp_path / "missing_ref.srt"), good[1], str(tmp_path / "x.srt"))
    results = sync_batch([bad, good])
    assert results[0]["error"] is not None
    assert not results[0]["sync_was_successful"]
    assert results[1]["sync_was_successful"]
    assert results[1]["offset_seconds"] == pytest.approx(1.0, abs=0.02)


def test_batch_cli_manifest(tmp_path, capsys, monkeypatch):
    jobs = [_make_job(tmp_path, "m%d" % i, s) for i, s in enumerate([2.0, -0.5])]
    manifest = tmp_path / "jobs.tsv"
    manifest.write_text("".join("%s\t%s\t%s\n" % job for job in jobs) + "# comment line\n")
    monkeypatch.setattr(sys, "argv", ["ffs-torch-batch", str(manifest)])
    assert batch_mod.main() == 0
    assert capsys.readouterr().out.count("OK") == 2


def test_batch_cli_rejects_malformed_manifest(tmp_path, monkeypatch):
    manifest = tmp_path / "jobs.tsv"
    manifest.write_text("only-one-column\n")
    monkeypatch.setattr(sys, "argv", ["ffs-torch-batch", str(manifest)])
    with pytest.raises(SystemExit):
        batch_mod.main()


def test_sync_batch_handles_ass_input(tmp_path):
    ref = tmp_path / "ref.srt"
    ref.write_text(_srt(SPANS))
    late = tmp_path / "late.ass"
    late.write_text(
        "[Script Info]\nTitle: t\n\n[Events]\n"
        "Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text\n"
        + "".join(
            "Dialogue: 0,%s,%s,Default,,0,0,0,,line %d\n"
            % ("0:%02d:%05.2f" % ((a - 1.0) // 60, (a - 1.0) % 60),
               "0:%02d:%05.2f" % ((b - 1.0) // 60, (b - 1.0) % 60), i)
            for i, (a, b) in enumerate(SPANS)
        )
    )
    out = tmp_path / "out.ass"
    [result] = sync_batch([(str(ref), str(late), str(out))])
    assert result["error"] is None
    assert result["offset_seconds"] == pytest.approx(1.0, abs=0.02)
    assert "Dialogue:" in out.read_text()


def test_sync_batch_rejects_empty_speech(tmp_path):
    ref = tmp_path / "ref.srt"
    ref.write_text(_srt(SPANS))
    empty = tmp_path / "empty.srt"
    empty.write_text("\n")
    [result] = sync_batch([(str(ref), str(empty), str(tmp_path / "out.srt"))])
    assert result["error"] is not None
    assert not result["sync_was_successful"]


def test_sync_batch_flags_low_quality_but_still_writes(tmp_path):
    [result] = sync_batch([_make_job(tmp_path, "lowq", -45.0)])
    assert result["error"] is None
    assert result["offset_seconds"] == pytest.approx(-45.0, abs=0.02)
    assert not result["sync_was_successful"]
    assert any("offset" in r for r in result["quality_reasons"])
    assert open(result["srtout"]).read()


def test_sync_batch_gss_refines_ratio(tmp_path):
    """Batched grid refinement recovers a ratio outside the discrete grid,
    each job from its OWN subtitle file, as the JAX package does."""
    true_ratio = 1.0137
    shifts = [2.0, -1.5]
    jobs = []
    for i, shift in enumerate(shifts):
        ref = tmp_path / ("g%d_ref.srt" % i)
        ref.write_text(_srt(SPANS))
        srtin = tmp_path / ("g%d_in.srt" % i)
        srtin.write_text(
            _srt([(a / true_ratio - shift, b / true_ratio - shift) for a, b in SPANS])
            .replace("line", "job%d line" % i)
        )
        jobs.append((str(ref), str(srtin), str(tmp_path / ("g%d_out.srt" % i))))
    want = jax_sync_batch(jobs, gss=True)
    results = sync_batch(jobs, gss=True)
    for i, (r, w) in enumerate(zip(results, want)):
        assert r["error"] is None, r["error"]
        assert r["framerate_scale_factor"] == pytest.approx(true_ratio, abs=2e-3)
        assert r["framerate_scale_factor"] == w["framerate_scale_factor"]
        assert r["offset_seconds"] == w["offset_seconds"]
        out_text = open(r["srtout"]).read()
        assert _ts(SPANS[0][0]).rsplit(",", 1)[0] in out_text
        assert "job%d line" % i in out_text
        assert "job%d line" % (1 - i) not in out_text


def test_sync_batch_output_encoding_same_preserves_input(tmp_path):
    ref = tmp_path / "ref.srt"
    ref.write_text(_srt(SPANS))
    srtin = tmp_path / "in.srt"
    body = _srt([(a - 1.0, b - 1.0) for a, b in SPANS]).replace("line 1", "ligne n° 1")
    srtin.write_bytes(body.encode("cp1252"))
    out = tmp_path / "out.srt"
    [result] = sync_batch([(str(ref), str(srtin), str(out))], output_encoding="same")
    assert result["error"] is None
    assert "ligne n° 1".encode("cp1252") in out.read_bytes()
    sync_batch([(str(ref), str(srtin), str(out))], output_encoding="utf-8")
    assert "ligne n° 1".encode("utf-8") in out.read_bytes()


def test_sync_batch_pgs_reference(tmp_path, monkeypatch):
    import ffsubsync_tpu_torch.media.pgs as pgs

    packets = [{"pts_time": str(a), "duration_time": str(b - a), "size": "4000"}
               for a, b in SPANS]
    streams = [{"codec_type": "subtitle", "codec_name": "hdmv_pgs_subtitle", "index": 2}]
    monkeypatch.setattr(pgs, "ffprobe_json", lambda *a, **k: {"streams": streams, "packets": packets})
    srtin = tmp_path / "in.srt"
    srtin.write_text(_srt([(a - 2.0, b - 2.0) for a, b in SPANS]))
    out = tmp_path / "out.srt"
    [result] = sync_batch([("movie.mkv", str(srtin), str(out))],
                          ref_options={"pgs_ref_stream": "auto"})
    assert result["error"] is None, result["error"]
    assert result["offset_seconds"] == pytest.approx(2.0, abs=0.02)
    assert _ts(SPANS[0][0]).rsplit(",", 1)[0] in out.read_text()


def test_sync_batch_requires_output_paths(tmp_path):
    job = _make_job(tmp_path, "q", 1.0)
    with pytest.raises(ValueError, match="output path"):
        sync_batch([(job[0], job[1], None)])


def _wav_jobs(tmp_path, shifts, rate=12000):
    jobs = []
    for i, shift in enumerate(shifts):
        rng = np.random.RandomState(10 + i)
        spans, t = [], 2.0
        while t < 36.0:
            length = rng.uniform(0.8, 3.0)
            spans.append((t, t + length))
            t += length + rng.uniform(0.7, 3.0)
        wav = str(tmp_path / ("ep%d.wav" % i))
        write_wav(wav, speech_signal_for_spans(40.0, spans, rate, speech_level=0.35), rate)
        srtin = tmp_path / ("ep%d.srt" % i)
        srtin.write_text(_srt([(a - shift, b - shift) for a, b in spans]))
        jobs.append((wav, str(srtin), str(tmp_path / ("ep%d.synced.srt" % i))))
    return jobs


def _recording(monkeypatch, cls):
    """Record every ``align_batch`` call's refs and alignments."""
    calls = []
    real = cls.align_batch

    def recording(self, refs, *args, **kwargs):
        out = real(self, refs, *args, **kwargs)
        calls.append((list(refs), out))
        return out

    monkeypatch.setattr(cls, "align_batch", recording)
    return calls


@pytest.mark.parametrize("vad", ["fused", "auditok"])
def test_wav_batch_equals_reference(tmp_path, monkeypatch, vad):
    """Audio references through both packages' sync_batch, pipeline chunks
    of 20 s (two per 40 s episode): the port's refs reach the aligner lazy,
    and every job's best score and scale equal the reference's. Fused
    labels are soft, so the offsets are equal too; auditok's hard tokens
    leave exact-tie plateaus whose pick f32 FFT rounding decides in either
    package (ROADMAP C4), so there the offset need only be on the plateau:
    the same exact score, near the truth."""
    from ffsubsync_tpu.parallel.batch import BatchAligner as JaxBatchAligner

    monkeypatch.setenv("FFS_TPU_PIPELINE_SECONDS", "20")
    # the reference's one-launch program (Pallas in interpret mode), which
    # the port's _vad_program mirrors, not its split CPU fallback
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    shifts = [1.3, -0.85, 2.2]
    jobs = _wav_jobs(tmp_path, shifts)
    ours, theirs = _recording(monkeypatch, BatchAligner), _recording(monkeypatch, JaxBatchAligner)
    got = sync_batch(jobs, vad=vad)
    want = jax_sync_batch(jobs, vad=vad)
    assert all(isinstance(r, LazySpeechSignal) for r in ours[0][0])
    for j, (g, w, shift) in enumerate(zip(got, want, shifts)):
        assert g["error"] is None and w["error"] is None
        assert g["sync_was_successful"] and w["sync_was_successful"]
        assert g["framerate_scale_factor"] == w["framerate_scale_factor"]
        assert g["offset_seconds"] == pytest.approx(shift, abs=0.15)
        best = [max(a.score for a in calls[0][1][j]) for calls in (ours, theirs)]
        labels = [np.asarray(calls[0][0][j], np.float64) for calls in (ours, theirs)]
        if vad == "fused":
            # labels agree to the label bar, not bit for bit; a score moves
            # by at most twice the labels' L1 distance (pm = 2x - 1)
            assert np.mean(np.abs(labels[0] - labels[1]) < 0.05) >= 0.995
            assert abs(best[0] - best[1]) <= 2 * np.abs(labels[0] - labels[1]).sum() + 1e-2
            assert g["offset_seconds"] == pytest.approx(w["offset_seconds"], abs=1e-9)
        else:
            np.testing.assert_array_equal(labels[0], labels[1])
            assert best[0] == pytest.approx(best[1], rel=SCORE_REL)


def test_wav_batch_cli_gss(tmp_path, monkeypatch, capsys):
    """``ffs-torch-batch --gss --vad fused`` on a WAV manifest (default
    output names) gives the JAX package's offsets and scales."""
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")
    jobs = _wav_jobs(tmp_path, [0.9, -1.6])
    manifest = tmp_path / "jobs.tsv"
    manifest.write_text("".join("%s\t%s\n" % job[:2] for job in jobs))
    monkeypatch.setattr(sys, "argv", ["ffs-torch-batch", "--gss", "--vad", "fused", str(manifest)])
    assert batch_mod.main() == 0
    lines = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    want = jax_sync_batch(jobs, vad="fused", gss=True)
    assert [ln[0] for ln in lines] == [j[1] for j in jobs]
    assert [float(ln[1]) for ln in lines] == pytest.approx(
        [w["offset_seconds"] for w in want], abs=1e-9)
    assert all(ln[2] == "OK" for ln in lines)
    for job in jobs:
        assert open(job[2]).read()
