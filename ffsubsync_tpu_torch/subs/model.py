# -*- coding: utf-8 -*-
"""Unified subtitle domain model.

The reference wraps third-party cue types (``srt.Subtitle`` / ``pysubs2.SSAEvent``)
in a ``GenericSubtitle`` (reference: ffsubsync/generic_subtitles.py:17-80) and
collects them in a ``GenericSubtitlesFile`` (:83-161). This framework carries its
own cue records instead of third-party ones, but keeps the same behavioral
surface: per-cue ``content``, document-level format/encoding/SSA-style metadata,
``offset``/``set_encoding``/``write_file`` with the same cross-format rules.

Times are integer microseconds. All float→time conversions round half-to-even,
matching ``datetime.timedelta(seconds=...)`` which the reference uses for every
shift/scale, so timestamp arithmetic is bit-identical to the reference.
"""
import os
import sys
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional

US_PER_SECOND = 1_000_000


def seconds_to_us(seconds: float) -> int:
    """Convert seconds to integer microseconds, rounding half-to-even.

    Mirrors ``timedelta(seconds=x)`` microsecond rounding so that shifted and
    scaled cue times match the reference's timedelta arithmetic exactly.
    """
    return round(seconds * US_PER_SECOND)


def us_to_seconds(us: int) -> float:
    return us / US_PER_SECOND


@dataclass
class SrtRecord:
    """Format-specific payload of a cue parsed from (or destined for) SRT."""

    index: Optional[int]
    content: str
    proprietary: str = ""


@dataclass
class SsaEventRecord:
    """Format-specific payload of an SSA/ASS ``Dialogue:`` (or ``Comment:``) event.

    ``fields`` holds the non-time event columns (Layer/Marked, Style, Name,
    MarginL, MarginR, MarginV, Effect) keyed by canonical field name so they
    survive a parse → transform → compose round trip.
    """

    text: str
    kind: str = "Dialogue"
    fields: Dict[str, str] = field(default_factory=dict)


@dataclass
class Cue:
    """A single subtitle cue: display interval plus format-specific payload."""

    start_us: int
    end_us: int
    inner: Any  # SrtRecord | SsaEventRecord

    @property
    def start_seconds(self) -> float:
        return us_to_seconds(self.start_us)

    @property
    def end_seconds(self) -> float:
        return us_to_seconds(self.end_us)

    @property
    def duration_seconds(self) -> float:
        return us_to_seconds(self.end_us - self.start_us)

    @property
    def content(self) -> str:
        """Raw cue text (with markup), used by the non-dialogue heuristic."""
        if isinstance(self.inner, SrtRecord):
            return self.inner.content
        if isinstance(self.inner, SsaEventRecord):
            return self.inner.text
        raise NotImplementedError("unsupported cue payload: %s" % type(self.inner))

    def with_times(self, start_us: int, end_us: int) -> "Cue":
        return Cue(start_us=start_us, end_us=end_us, inner=self.inner)

    def merge_with(self, other: "Cue") -> "Cue":
        """Concatenate another cue's text into this one (keeps this cue's span).

        Only text (SRT-payload) cues support merging, as in the reference
        (generic_subtitles.py:58-69).
        """
        if not isinstance(self.inner, SrtRecord) or not isinstance(
            other.inner, SrtRecord
        ):
            raise NotImplementedError(
                "merging is only supported for srt-format cues"
            )
        merged = replace(
            self.inner,
            content="{}\n{}".format(self.inner.content, other.inner.content),
        )
        return Cue(start_us=self.start_us, end_us=self.end_us, inner=merged)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Cue):
            return False
        return (
            self.start_us == other.start_us
            and self.end_us == other.end_us
            and self.inner == other.inner
        )


class SubtitleDocument:
    """An ordered collection of cues plus document-level metadata.

    Equivalent of the reference's ``GenericSubtitlesFile``: knows its source
    format and encoding, preserves SSA styles / script info / fonts across
    transformations, and implements cross-format serialization.
    """

    def __init__(
        self,
        cues: List[Cue],
        sub_format: str,
        encoding: str,
        styles: Optional[Dict[str, Dict[str, str]]] = None,
        info: Optional[Dict[str, str]] = None,
        fonts_opaque: Optional[Any] = None,
        styles_format_line: Optional[List[str]] = None,
        events_format_line: Optional[List[str]] = None,
    ) -> None:
        if sub_format is None:
            raise ValueError("format must be specified")
        if encoding is None:
            raise ValueError("encoding must be specified")
        self.cues: List[Cue] = cues
        self.sub_format: str = sub_format
        self.encoding: str = encoding
        self.styles = styles
        self.info = info
        self.fonts_opaque = fonts_opaque
        # Column layouts of the source [V4+ Styles] / [Events] sections, kept so
        # a round trip preserves the original field order.
        self.styles_format_line = styles_format_line
        self.events_format_line = events_format_line

    def __len__(self) -> int:
        return len(self.cues)

    def __getitem__(self, item: int) -> Cue:
        return self.cues[item]

    def __iter__(self) -> Iterator[Cue]:
        return iter(self.cues)

    def set_encoding(self, encoding: str) -> "SubtitleDocument":
        if encoding != "same":
            self.encoding = encoding
        return self

    def clone_props_for_subs(self, new_cues: List[Cue]) -> "SubtitleDocument":
        return SubtitleDocument(
            new_cues,
            sub_format=self.sub_format,
            encoding=self.encoding,
            styles=self.styles,
            info=self.info,
            fonts_opaque=self.fonts_opaque,
            styles_format_line=self.styles_format_line,
            events_format_line=self.events_format_line,
        )

    def offset(self, offset_seconds: float) -> "SubtitleDocument":
        delta_us = seconds_to_us(offset_seconds)
        return self.clone_props_for_subs(
            [c.with_times(c.start_us + delta_us, c.end_us + delta_us) for c in self.cues]
        )

    def to_string(self, out_format: Optional[str] = None) -> str:
        """Serialize, possibly converting to a different output format.

        Mirrors the reference's write dispatch (generic_subtitles.py:134-158):
        SSA-family sources always go through the SSA composer (which can emit
        srt/vtt/ssa/ass); an SRT source headed to an SSA-family output is
        converted; an SRT source to SRT composes directly.
        """
        from ffsubsync_tpu_torch.subs import formats

        return formats.compose_document(self, out_format)

    def write_file(self, fname: Optional[str]) -> None:
        if fname is None:
            out_format = self.sub_format
        else:
            out_format = os.path.splitext(fname)[-1][1:]
        to_write = self.to_string(out_format)
        if fname is None:
            # write to stdout WITHOUT closing the process's fd (library
            # callers keep printing afterwards); tolerate replaced stdouts
            # (pytest capture, embedders) that have no binary buffer
            buffer = getattr(sys.stdout, "buffer", None)
            if buffer is not None:
                buffer.write(to_write.encode(self.encoding))
                buffer.flush()
            else:
                sys.stdout.write(to_write)
                sys.stdout.flush()
            return
        with open(fname, "wb") as f:
            f.write(to_write.encode(self.encoding))
