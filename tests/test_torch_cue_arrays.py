# -*- coding: utf-8 -*-
"""The candidate rasters of ``ops/cues``: each ratio's spec from a
document's cue arrays equals the pinned ``rasterize_cues(scale_document(
doc, ratio).cues, ...)`` bit for bit; the single-file and the batch sync
write the same bytes with it as with the pinned ``SubtitleSpeechSource``;
and the counters count one document's arrays for all its candidates."""
import numpy as np
import pytest
import torch

from ffsubsync_tpu_torch import sync
from ffsubsync_tpu_torch.batch import sync_batch
from ffsubsync_tpu_torch.cli import make_parser
from ffsubsync_tpu_torch.constants import FRAMERATE_RATIOS, SAMPLE_RATE
from ffsubsync_tpu_torch.ops import cues
from ffsubsync_tpu_torch.ops.cues import CandidateSource, CueArrays, cue_arrays
from ffsubsync_tpu_torch.speech import SubtitleSpeechSource
from ffsubsync_tpu_torch.subs.model import Cue, SrtRecord, SubtitleDocument
from ffsubsync_tpu_torch.subs.parser import make_subtitle_parser
from ffsubsync_tpu_torch.subs.raster import rasterize_cues
from ffsubsync_tpu_torch.subs.transforms import scale_document
from ffsubsync_tpu_torch.utils import tracing

from tests.test_sync_e2e import REF_SRT, _make_unsynced, _write
from tests.test_torch_sync_e2e import _make_media

torch.set_num_threads(1)

GRID = [1.0] + FRAMERATE_RATIOS + [1.0 / r for r in FRAMERATE_RATIOS]
INFERRED = 1.0372619047619047  # a ratio of durations, off the grid
GSS = sync.gss_grid(sync.MIN_FRAMERATE_RATIO, sync.MAX_FRAMERATE_RATIO)[1]
RATIOS = GRID + [INFERRED] + GSS


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _doc(times_and_texts):
    return SubtitleDocument(
        [Cue(a, b, SrtRecord(i + 1, text)) for i, (a, b, text) in enumerate(times_and_texts)],
        sub_format="srt", encoding="utf-8",
    )


def _assert_same(got, want):
    assert type(got.n_samples) is type(want.n_samples) and got.n_samples == want.n_samples
    for name in ("starts", "ends"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        assert np.array_equal(g, w), name
    # floats compared by their bits: 0.0 against -0.0 would differ
    assert np.float64(got.weight).tobytes() == np.float64(want.weight).tobytes()
    assert np.float64(got.max_time).tobytes() == np.float64(want.max_time).tobytes()
    assert got.sample_rate == want.sample_rate


def _pinned(doc, ratio, start_seconds):
    return rasterize_cues(scale_document(doc, ratio).cues, SAMPLE_RATE, start_seconds, ratio)


def _random_doc(rng, n, hours):
    """``n`` cues at random microseconds over ``hours``: starts sorted,
    durations up to 8 s, some overlapping the next cue, some zero-length."""
    starts = np.sort(rng.integers(0, int(hours * 3600e6), n))
    durations = rng.integers(0, 8_000_000, n)
    durations[rng.random(n) < 0.05] = 0
    texts = ["line %d" % i for i in range(n)]
    return _doc([(int(a), int(a + d), t) for a, d, t in zip(starts, durations, texts)])


METADATA_DOC = _doc([
    (1_000_000, 2_500_000, "Subtitles in English by someone"),  # first cue: "english"
    (3_000_000, 4_000_000, "[door slams]"),
    (4_500_000, 6_000_000, "<i>[music]</i>"),  # markup stripped first
    (6_000_000, 6_000_000, "Zero length."),
    (6_500_000, 9_000_000, "Overlaps the next."),
    (8_000_000, 9_500_000, "♪ ♫"),
    (9_500_000, 11_000_000, "<i>Hello?</i>"),
    (11_005_000, 12_335_000, "（笑）"),
    (12_500_000, 13_000_000, "A - B inside is dialogue"),
    (13_000_000, 14_000_000, "   "),
    (14_000_000, 15_000_000, "Synced - by nobody"),  # last cue: " - "
])

DOCS = {
    "metadata": METADATA_DOC,
    "empty": _doc([]),
    "all_metadata": _doc([(1_000_000, 2_000_000, "[a]"), (3_000_000, 4_000_000, "♪")]),
    "random_1100": _random_doc(np.random.default_rng(11), 1100, 1.5),
    "ten_hours": _random_doc(np.random.default_rng(12), 12_000, 10.0),
    "one_cue": _doc([(5_000_000, 7_500_000, "Hello there.")]),
    # at 23.976/24, (us / 1e6 * r) * 1e6 rounds to 35,465,000 µs, us * r to
    # 35,464,999: a sample apart at 100 Hz, so the order of the operations shows
    "rounding_order": _doc([(35_500_500, 36_000_000, "a"), (45_500_500, 46_000_000, "b"),
                            (85_500_500, 85_900_000, "c"),
                            (16_494_499_500, 16_495_000_000, "d")]),
}


@pytest.mark.parametrize("start_seconds", [0, 5, 2.5])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_spec_equals_the_pinned_raster_at_every_ratio(name, start_seconds):
    doc = DOCS[name]
    arrays = CueArrays(doc)
    for ratio in RATIOS:
        _assert_same(arrays.spec(ratio, start_seconds), _pinned(doc, ratio, start_seconds))


def test_a_negative_scaled_start_wraps_as_numpy_slices_do():
    """A kept cue at the start (5 s) scaled by 0.9 lands 0.5 s before it:
    the start index is negative and numpy's slice counts it from the end."""
    doc = _doc([(5_000_000, 6_000_000, "Early."), (20_000_000, 22_000_000, "Late.")])
    want = _pinned(doc, 0.9, 5)
    assert want.starts[0] > 0 and want.starts[0] == want.n_samples - 50
    _assert_same(CueArrays(doc).spec(0.9, 5), want)


def test_the_metadata_mask_is_the_pinned_heuristic():
    keep = CueArrays(METADATA_DOC).keep
    assert keep.tolist() == [False, False, False, True, True, False, True, False, True,
                             False, False]


ASS_TEXT = """[Script Info]
Title: Test Script
ScriptType: v4.00+

[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding
Style: Default,Arial,20,&H00FFFFFF,&H000000FF,&H00000000,&H00000000,0,0,0,0,100,100,0,0,1,2,0,2,10,10,10,1

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text
Dialogue: 0,0:00:05.00,0:00:07.50,Default,,0,0,0,,English subtitles
Dialogue: 0,0:00:12.25,0:00:15.00,Default,,0,0,0,,{\\i1}General Kenobi!{\\i0}
Dialogue: 0,0:00:14.00,0:00:14.00,Default,,0,0,0,,Zero.
Dialogue: 0,0:00:21.00,0:00:24.40,Default,,0,0,0,,[laughs]
Dialogue: 0,0:00:31.70,0:00:34.00,Default,,0,0,0,,Back away!
"""


@pytest.mark.parametrize("start_seconds", [0, 12.25])
@pytest.mark.parametrize("fmt", ["srt", "ass"])
def test_a_fitted_candidate_equals_the_pinned_source(tmp_path, fmt, start_seconds):
    """Parsed from a file, through each class's ``fit`` on one caching
    parser: the same spec, frames and scaled document at every ratio."""
    path = _write(tmp_path, "in." + fmt, REF_SRT if fmt == "srt" else ASS_TEXT)
    parser = make_subtitle_parser(fmt, caching=True, start_seconds=start_seconds)
    for ratio in RATIOS:
        kwargs = dict(fmt=fmt, scale_factor=ratio, parser=parser, start_seconds=start_seconds)
        want = SubtitleSpeechSource(**kwargs).fit(path)
        got = CandidateSource(**kwargs).fit(path)
        _assert_same(got.spec_, want.spec_)
        assert got.parsed_doc_ is want.parsed_doc_
        assert got.num_frames == want.num_frames and got.scale_factor == ratio
        assert got.scaled_doc_.cues == want.scaled_doc_.cues
        assert got.scaled_doc_.sub_format == want.scaled_doc_.sub_format == fmt
        assert np.array_equal(got.transform(), want.transform())
        assert got.signal_or_spec() is got.spec_


def test_the_scaled_document_is_built_when_first_read(tmp_path, monkeypatch):
    path = _write(tmp_path, "in.srt", REF_SRT)
    built = []
    real = cues.scale_document
    monkeypatch.setattr(cues, "scale_document", lambda *a: built.append(a) or real(*a))
    source = CandidateSource(scale_factor=1.25, parser=make_subtitle_parser("srt", caching=True))
    assert source.scaled_doc_ is None
    source.fit(path)
    assert built == []
    doc = source.scaled_doc_
    assert source.scaled_doc_ is doc and len(built) == 1
    assert doc.cues == scale_document(source.parsed_doc_, 1.25).cues
    source.fit(path)  # a new fit forgets the old ratio's document
    assert source.scaled_doc_ is not doc and len(built) == 2


def test_one_documents_arrays_serve_every_ratio(tmp_path):
    path = _write(tmp_path, "in.srt", REF_SRT)
    parser = make_subtitle_parser("srt", caching=True)
    pinned = SubtitleSpeechSource(scale_factor=1.0, parser=parser)
    with tracing.recording() as rec:
        sources = [CandidateSource.of(pinned).fit(path) for _ in range(5)]
        arrays = cue_arrays(parser.subs_)
    assert all(s.parser is parser for s in sources)
    assert rec.counters["raster.fits"] == rec.counts["raster"] == 5
    assert rec.counters["raster.cue_arrays"] == 1
    assert rec.counts["parse"] == 1
    assert cue_arrays(sources[-1].parsed_doc_) is arrays


class _Pinned(SubtitleSpeechSource):
    """The pinned source where the callers build a ``CandidateSource``."""

    @classmethod
    def of(cls, source):
        return source


def _pin(monkeypatch):
    monkeypatch.setattr(sync, "CandidateSource", _Pinned)
    monkeypatch.setattr(cues, "CandidateSource", _Pinned)


def _run(media, srtin, out, flags):
    return sync.run(make_parser().parse_args([media, "-i", srtin, "-o", out] + flags))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A WAV reference whose speech lies on REF_SRT's cues, its subtitles
    in UTF-16 (so ``--output-encoding same`` differs from the default),
    and the input subtitles slowed by 1.043 and shifted by 1.3 s."""
    tmp_path = tmp_path_factory.mktemp("cues")
    media = _make_media(tmp_path)
    truth = _write(tmp_path, "truth.srt", REF_SRT)
    srtin = _make_unsynced(tmp_path, truth, 1.3, scale=1.043)
    with open(srtin, encoding="utf-8") as f:
        text = f.read()
    with open(srtin, "w", encoding="utf-16") as f:
        f.write(text)
    return tmp_path, media, truth, srtin


FLAGS = {
    "grid": ["--vad", "webrtc"],
    "gss": ["--vad", "webrtc", "--gss"],
    "same_encoding": ["--vad", "webrtc", "--output-encoding", "same"],
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_single_file_sync_writes_what_the_pinned_source_writes(case, monkeypatch, flags):
    tmp_path, media, _truth, srtin = case
    outs, results = [], []
    for pinned in (False, True):
        if pinned:
            _pin(monkeypatch)
        out = str(tmp_path / ("%s_%d.srt" % (flags, pinned)))
        with tracing.recording() as rec:
            results.append(_run(media, srtin, out, FLAGS[flags]))
        assert rec.counters.get("raster.fits", 0) == (0 if pinned else
                                                    7 + (99 if flags == "gss" else 0))
        with open(out, "rb") as f:
            outs.append(f.read())
    got, want = results
    assert got["sync_was_successful"] and want["sync_was_successful"]
    assert got["offset_seconds"] == want["offset_seconds"]
    assert got["framerate_scale_factor"] == want["framerate_scale_factor"]
    assert outs[0] == outs[1]
    if flags == "same_encoding":
        assert outs[0].startswith(b"\xff\xfe")  # UTF-16, as the input was


@pytest.mark.parametrize("gss", [False, True], ids=["grid", "gss"])
def test_batch_sync_writes_what_the_pinned_source_writes(case, monkeypatch, gss):
    """Two jobs on the WAV and one on a subtitle reference (an inferred
    ratio), output in each input's encoding."""
    tmp_path, media, truth, srtin = case
    outs, results = [], []
    for pinned in (False, True):
        if pinned:
            _pin(monkeypatch)
        jobs = [(ref, srtin, str(tmp_path / ("b%d_%d_%d.srt" % (gss, pinned, j))))
                for j, ref in enumerate([media, media, truth])]
        results.append(sync_batch(jobs, vad="webrtc", gss=gss, output_encoding="same"))
        outs.append([open(o, "rb").read() for _r, _s, o in jobs])
    for got, want in zip(*results):
        assert got["error"] is want["error"] is None
        assert got["offset_seconds"] == want["offset_seconds"]
        assert got["framerate_scale_factor"] == want["framerate_scale_factor"]
    assert outs[0] == outs[1]


def test_counters_of_a_sync_and_a_batch(case, monkeypatch):
    """One ``try_sync`` on a WAV reference fits the 7 grid ratios on one
    set of arrays; on a subtitle reference (``num_frames`` known) an 8th,
    the inferred ratio; a batch of 3 WAV jobs 21 on 3."""
    tmp_path, media, truth, srtin = case
    with tracing.recording() as wav_rec:
        _run(media, srtin, str(tmp_path / "c_wav.srt"), ["--vad", "webrtc"])
    with tracing.recording() as srt_rec:
        _run(truth, srtin, str(tmp_path / "c_srt.srt"), [])
    jobs = [(media, srtin, str(tmp_path / ("c_b%d.srt" % j))) for j in range(3)]
    with tracing.recording() as batch_rec:
        sync_batch(jobs, vad="webrtc")
    for rec, fits, arrays in ((wav_rec, 7, 1), (srt_rec, 8, 1), (batch_rec, 21, 3)):
        assert rec.counters["raster.fits"] == fits
        assert rec.counters["raster.cue_arrays"] == arrays
    # the subtitle reference's own fit is the pinned source's: a raster span
    # that counts no candidate
    assert srt_rec.counts["raster"] == 9


def test_a_subtitle_reference_keeps_the_pinned_source():
    """A reference is fitted once: it has no ratios to share arrays over."""
    args = make_parser().parse_args(["ref.srt", "-i", "in.srt"])
    assert type(sync.make_reference_extractor(args)) is SubtitleSpeechSource
