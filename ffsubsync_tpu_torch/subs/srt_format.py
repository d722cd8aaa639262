# -*- coding: utf-8 -*-
"""In-tree SRT (SubRip) parser / composer.

The reference delegates SRT handling to the third-party ``srt`` library
(ffsubsync/subtitle_parser.py:116-118, generic_subtitles.py:156). This module
is an original implementation with the same observable behavior:

- timestamps are ``H:MM:SS,mmm`` with a *literal integer* milliseconds field,
  so malformed >3-digit fields like ``00:00:01,1416`` parse as 1416 ms
  (exercised by the reference's tests/test_subtitles.py:27-32);
- ``,`` or ``.`` (and other common delimiters) accepted between seconds and ms;
- tolerant mode skips malformed blocks (like ``srt.parse(ignore_errors=True)``),
  strict mode raises;
- composing sorts cues by (start, end), renumbers from 1, truncates times to
  whole milliseconds, and emits ``\\n``-separated blocks with a trailing newline
  (like ``srt.compose`` defaults).
"""
import logging
import re
from typing import Iterator, List, Optional

from ffsubsync_tpu_torch.subs.model import Cue, SrtRecord

logger = logging.getLogger(__name__)

US_PER_HOUR = 3_600_000_000
US_PER_MINUTE = 60_000_000
US_PER_SECOND = 1_000_000
US_PER_MS = 1_000
US_PER_DAY = 86_400_000_000


class SubtitleParseError(ValueError):
    """Raised in strict mode when a subtitle block cannot be parsed."""


# signed hours: shifted subtitles can carry negative times (e.g.
# ``-1:59:20,000`` = -40 s), and they must survive a compose → parse round trip
_TIMESTAMP = r"(-?\d+):(\d{1,2}):(\d{1,2})[,.:](\d+)"
# " --> " with tolerance for missing spaces and en-dash arrows
_TIMING_LINE = re.compile(
    r"\s*" + _TIMESTAMP + r"\s*[-–]+>\s*" + _TIMESTAMP + r"(?:\s+(?P<pos>.*))?\s*$"
)


def _fields_to_us(h: str, m: str, s: str, ms: str) -> int:
    # The milliseconds field is taken as a literal integer: "1416" is 1416 ms.
    return (
        int(h) * US_PER_HOUR
        + int(m) * US_PER_MINUTE
        + int(s) * US_PER_SECOND
        + int(ms) * US_PER_MS
    )


def parse(text: str, tolerant: bool = True) -> Iterator[Cue]:
    """Yield :class:`Cue` objects parsed from SRT *text*.

    In tolerant mode, blocks without a parseable timing line are skipped with a
    warning; in strict mode a :class:`SubtitleParseError` is raised.
    """
    if text.startswith("﻿"):
        text = text[1:]
    lines = text.split("\n")
    i = 0
    n = len(lines)
    while i < n:
        # skip blank lines between blocks
        while i < n and not lines[i].strip():
            i += 1
        if i >= n:
            break
        block_start = i
        # optional index line(s) before the timing line; the timing line must
        # appear within the first two lines of the block
        timing_match = None
        index: Optional[int] = None
        for probe in range(i, min(i + 2, n)):
            timing_match = _TIMING_LINE.match(lines[probe])
            if timing_match is not None:
                if probe > i:
                    idx_text = lines[i].strip()
                    try:
                        index = int(idx_text)
                    except ValueError:
                        index = None
                i = probe
                break
        if timing_match is None:
            # malformed block: consume it (up to next blank line)
            while i < n and lines[i].strip():
                i += 1
            bad = "\n".join(lines[block_start:i])
            if tolerant:
                logger.warning("skipping malformed srt block: %r", bad[:80])
                continue
            raise SubtitleParseError("malformed srt block: %r" % bad[:200])
        g = timing_match.groups()
        start_us = _fields_to_us(g[0], g[1], g[2], g[3])
        end_us = _fields_to_us(g[4], g[5], g[6], g[7])
        proprietary = timing_match.group("pos") or ""
        i += 1
        content_lines: List[str] = []
        while i < n and lines[i].strip():
            content_lines.append(lines[i])
            i += 1
        content = "\n".join(content_lines)
        yield Cue(
            start_us=start_us,
            end_us=end_us,
            inner=SrtRecord(index=index, content=content, proprietary=proprietary),
        )


def format_timestamp(us: int) -> str:
    """Format integer microseconds as an SRT timestamp, truncating to ms.

    Uses floor-division semantics so negative times render the same way the
    reference's timedelta-based composer does (e.g. -1 s → ``-1:59:59,000``).
    """
    days, rem = divmod(us, US_PER_DAY)
    hrs, rem = divmod(rem, US_PER_HOUR)
    hrs += days * 24
    mins, rem = divmod(rem, US_PER_MINUTE)
    secs, rem = divmod(rem, US_PER_SECOND)
    msecs = rem // US_PER_MS
    return "%02d:%02d:%02d,%03d" % (hrs, mins, secs, msecs)


def compose(cues: List[Cue], reindex: bool = True) -> str:
    """Serialize cues to SRT text (sorted, renumbered, trailing newline)."""
    if reindex:
        cues = sorted(cues, key=lambda c: (c.start_us, c.end_us))
    blocks = []
    for i, cue in enumerate(cues):
        rec = cue.inner
        if isinstance(rec, SrtRecord):
            content = rec.content
            proprietary = rec.proprietary
            index = rec.index
        else:  # cross-format: any payload with text-like content
            content = cue.content
            proprietary = ""
            index = None
        if reindex or index is None:
            index = i + 1
        timing = "{} --> {}".format(
            format_timestamp(cue.start_us), format_timestamp(cue.end_us)
        )
        if proprietary:
            timing = "{} {}".format(timing, proprietary)
        blocks.append("{}\n{}\n{}\n".format(index, timing, content))
    # each block is followed by exactly one blank line, including the last
    return "".join(block + "\n" for block in blocks)
