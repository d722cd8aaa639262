# -*- coding: utf-8 -*-
"""The candidate search that the single-file and the batch sync share:
``sync_batch`` of one job against ``sync.run`` on the same files, a
two-job ``--gss`` batch against the JAX package's, and the two hooked
entries of the search (``sync.align_candidates``, ``BatchAligner.
align_batch``), each reached once per search and never inside the other."""
import logging
import re

import pytest
import torch

from ffsubsync_tpu.batch import sync_batch as jax_sync_batch
from ffsubsync_tpu.parallel.batch import BatchAligner as JaxBatchAligner
from ffsubsync_tpu_torch import sync
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.cli import make_parser
from ffsubsync_tpu_torch.parallel.batch import BatchAligner
from ffsubsync_tpu_torch.utils import tracing

from tests.test_batch import SPANS, _srt
from tests.test_torch_batch import _recording
from tests.test_torch_sync_e2e import _make_media
from tests.test_sync_e2e import REF_SRT, _make_unsynced, _write

torch.set_num_threads(1)

# near the top of the [0.9, 1.1] range: the first round's best ratio is 1.1,
# so the next bracket is clamped there
EDGE_RATIO = 1.099
GSS_ROUND = re.compile(r"gss grid \[([0-9.]+), ([0-9.]+)\]: best ratio")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _wav_case(tmp_path):
    """A WAV reference (synthetic speech on REF_SRT's cues) and subtitles
    slowed by EDGE_RATIO and shifted by 1.3 s."""
    media = _make_media(tmp_path)
    truth = _write(tmp_path, "truth.srt", REF_SRT)
    return media, _make_unsynced(tmp_path, truth, 1.3, scale=EDGE_RATIO)


def _run_single(media, srtin, out, gss):
    argv = [media, "-i", srtin, "-o", out, "--vad", "webrtc"] + (["--gss"] if gss else [])
    return sync.run(make_parser().parse_args(argv))


def _hook_counts(monkeypatch):
    """Count the calls that reach each hooked entry of the search."""
    calls = {"align_candidates": 0, "align_batch": 0}
    real_align, real_batch = sync.align_candidates, BatchAligner.align_batch

    def align_candidates(*args, **kwargs):
        calls["align_candidates"] += 1
        return real_align(*args, **kwargs)

    def align_batch(*args, **kwargs):
        calls["align_batch"] += 1
        return real_batch(*args, **kwargs)

    monkeypatch.setattr(sync, "align_candidates", align_candidates)
    monkeypatch.setattr(BatchAligner, "align_batch", align_batch)
    return calls


def _nested_aligns(rec):
    """The ``align`` spans that have an ``align`` span above them."""
    by_id = {s.id: s for s in rec.spans}
    nested = []
    for s in rec.spans:
        if s.name != "align":
            continue
        parent = by_id.get(s.parent)
        while parent is not None:
            if parent.name == "align":
                nested.append(s)
                break
            parent = by_id.get(parent.parent)
    return nested


@pytest.mark.parametrize("gss", [False, True], ids=["grid", "gss"])
def test_batch_of_one_equals_single_file_sync(tmp_path, monkeypatch, gss):
    """A WAV reference under ``--vad webrtc``, so both entries score on the
    device: the same offset, scale and written bytes. Single-file reaches
    only ``sync.align_candidates``, once plus once per gss round; the batch
    only ``BatchAligner.align_batch``, as often; no ``align`` span nests in
    another."""
    media, srtin = _wav_case(tmp_path)
    calls = _hook_counts(monkeypatch)
    single_out, batch_out = str(tmp_path / "single.srt"), str(tmp_path / "batch.srt")
    with tracing.recording() as single_rec:
        single = _run_single(media, srtin, single_out, gss)
    single_calls = dict(calls)
    with tracing.recording() as batch_rec:
        (batched,) = sync_batch([(media, srtin, batch_out)], vad="webrtc", gss=gss)
    rounds = 3 if gss else 0
    assert single_calls == {"align_candidates": 1 + rounds, "align_batch": 0}
    assert calls == {"align_candidates": 1 + rounds, "align_batch": 1 + rounds}
    assert single_rec.counts["align"] == batch_rec.counts["align"] == 1 + rounds
    assert _nested_aligns(single_rec) == _nested_aligns(batch_rec) == []
    assert batched["error"] is None
    assert batched["offset_seconds"] == single["offset_seconds"]
    assert batched["framerate_scale_factor"] == single["framerate_scale_factor"]
    with open(single_out, "rb") as f, open(batch_out, "rb") as g:
        assert g.read() == f.read()
    if gss:  # the grid alone holds no ratio near EDGE_RATIO
        assert single["framerate_scale_factor"] == pytest.approx(EDGE_RATIO, abs=2e-3)
        assert single["offset_seconds"] == pytest.approx(1.3, abs=0.15)


def test_two_job_gss_batch_equals_reference(tmp_path, monkeypatch, caplog):
    """One job whose bracket is clamped at 1.1 after the first round and
    one inside the range: the JAX package's results and number of searches
    (the grid, then three gss rounds), and one info line per job and
    round."""
    jobs = []
    for i, (ratio, shift) in enumerate([(EDGE_RATIO, 2.0), (1.0137, -1.5)]):
        ref = tmp_path / ("c%d_ref.srt" % i)
        ref.write_text(_srt(SPANS))
        srtin = tmp_path / ("c%d_in.srt" % i)
        srtin.write_text(_srt([(a / ratio - shift, b / ratio - shift) for a, b in SPANS]))
        jobs.append((str(ref), str(srtin), str(tmp_path / ("c%d_out.srt" % i))))
    ours, theirs = _recording(monkeypatch, BatchAligner), _recording(monkeypatch, JaxBatchAligner)
    want = jax_sync_batch(jobs, gss=True)
    written = [open(j[2], "rb").read() for j in jobs]
    with caplog.at_level(logging.INFO, logger=sync.logger.name):
        got = sync_batch(jobs, gss=True)
    assert got == want
    assert [open(j[2], "rb").read() for j in jobs] == written
    assert len(ours) == len(theirs) == 4
    assert got[0]["framerate_scale_factor"] == pytest.approx(EDGE_RATIO, abs=2e-3)
    assert got[1]["framerate_scale_factor"] == pytest.approx(1.0137, abs=2e-3)
    brackets = [tuple(map(float, GSS_ROUND.search(r.getMessage()).groups()))
                for r in caplog.records if GSS_ROUND.search(r.getMessage())]
    assert len(brackets) == 2 * 3
    assert brackets[0] == brackets[1] == (0.9, 1.1)
    assert brackets[2][1] == 1.1 and brackets[3][1] < 1.1
