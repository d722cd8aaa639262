# -*- coding: utf-8 -*-
"""Pure subtitle-document transforms: shift, scale, merge.

These replace the reference's transformer classes
(ffsubsync/subtitle_transformers.py:13-125) with plain functions over
:class:`SubtitleDocument`. Time arithmetic matches the reference's
timedelta-based math exactly (integer microseconds with half-to-even
rounding at every float conversion).
"""
from typing import Iterator, List, Optional

from ffsubsync_tpu_torch.subs.model import Cue, SubtitleDocument, seconds_to_us, us_to_seconds


def shift_document(doc: SubtitleDocument, offset_seconds: float) -> SubtitleDocument:
    return doc.offset(offset_seconds)


def scale_document(doc: SubtitleDocument, scale_factor: float) -> SubtitleDocument:
    """Multiply every cue's start/end (as total seconds) by *scale_factor*.

    Matches ``SubtitleScaler`` (subtitle_transformers.py:35-47): the product is
    computed in float seconds and re-rounded to microseconds.
    """
    scaled = [
        cue.with_times(
            seconds_to_us(us_to_seconds(cue.start_us) * scale_factor),
            seconds_to_us(us_to_seconds(cue.end_us) * scale_factor),
        )
        for cue in doc.cues
    ]
    return doc.clone_props_for_subs(scaled)


def _merger_gen(a: List[Cue], b: List[Cue]) -> Iterator[Cue]:
    """Interleave two start-sorted cue streams, merging nearest-neighbor pairs.

    Behavioral parity with the reference's generator
    (subtitle_transformers.py:61-112): walk both streams in start order; when a
    cue from stream B falls between consecutive cues of stream A, merge it into
    whichever A-neighbor starts closer (the earlier-starting cue of a merged
    pair absorbs the later one's text below its own).
    """
    ita, itb = iter(a), iter(b)
    cur_a: Optional[Cue] = next(ita, None)
    cur_b: Optional[Cue] = next(itb, None)
    while True:
        if cur_a is None and cur_b is None:
            return
        if cur_a is None:
            while cur_b is not None:
                yield cur_b
                cur_b = next(itb, None)
            return
        if cur_b is None:
            while cur_a is not None:
                yield cur_a
                cur_a = next(ita, None)
            return
        # ensure the "a" role holds the earlier-starting current cue
        if cur_a.start_us < cur_b.start_us:
            swapped = False
        else:
            swapped = True
            cur_a, cur_b = cur_b, cur_a
            ita, itb = itb, ita
        # advance "a" until it passes cur_b, yielding all but the last cue
        # before cur_b (the candidate for merging)
        prev_a = cur_a
        while prev_a is not None and cur_a.start_us < cur_b.start_us:
            cur_a = next(ita, None)
            if cur_a is None or cur_a.start_us < cur_b.start_us:
                yield prev_a
                prev_a = cur_a
        if prev_a is None:
            while cur_b is not None:
                yield cur_b
                cur_b = next(itb, None)
            return
        # merge cur_b into its nearest neighbor among (prev_a, cur_a)
        if cur_b.start_us - prev_a.start_us < cur_a.start_us - cur_b.start_us:
            if swapped:
                yield cur_b.merge_with(prev_a)
                ita, itb = itb, ita
                cur_a, cur_b = cur_b, cur_a
                cur_a = next(ita, None)
            else:
                yield prev_a.merge_with(cur_b)
                cur_b = next(itb, None)
        else:
            if swapped:
                yield cur_b.merge_with(cur_a)
                ita, itb = itb, ita
            else:
                yield cur_a.merge_with(cur_b)
            cur_a = next(ita, None)
            cur_b = next(itb, None)


def merge_documents(
    output_doc: SubtitleDocument,
    reference_doc: SubtitleDocument,
    first: str = "reference",
) -> SubtitleDocument:
    """Merge reference cues into the synced output (``--merge-with-reference``)."""
    assert first in ("reference", "output")
    if first == "reference":
        a, b = list(reference_doc.cues), list(output_doc.cues)
    else:
        a, b = list(output_doc.cues), list(reference_doc.cues)
    merged = list(_merger_gen(a, b))
    return output_doc.clone_props_for_subs(merged)
