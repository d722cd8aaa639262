# -*- coding: utf-8 -*-
"""Format dispatch: decoded text → :class:`SubtitleDocument` and back.

Parse dispatch mirrors the reference (ffsubsync/subtitle_parser.py:116-124):
"srt" goes to the SRT parser; "ass"/"ssa"/"sub"/"vtt" go through format
auto-detection (the role pysubs2's ``SSAFile.from_string`` plays there).
Compose dispatch mirrors generic_subtitles.py:134-158, including cross-format
output (e.g. parse srt, write vtt), except that payload-agnostic composers
make conversions work in every direction rather than only the reference's
supported subset.
"""
from typing import List, Optional

from ffsubsync_tpu_torch.subs import srt_format, ssa_format
from ffsubsync_tpu_torch.subs.model import Cue, SubtitleDocument

SSA_FAMILY = ("ssa", "ass", "vtt")


def parse_document(
    text: str,
    fmt: str,
    encoding: str,
    strict: bool = False,
) -> SubtitleDocument:
    """Parse decoded subtitle *text* declared (by extension) as *fmt*.

    The document's ``sub_format`` is the *declared* format, matching the
    reference's behavior of keying write dispatch off the input extension.
    """
    if fmt == "srt":
        cues = list(srt_format.parse(text, tolerant=not strict))
        return SubtitleDocument(cues, sub_format=fmt, encoding=encoding)
    if fmt in ("ass", "ssa", "sub", "vtt"):
        detected = ssa_format.detect_format(text) or fmt
        if detected in ("ass", "ssa"):
            (
                cues,
                styles,
                info,
                fonts_opaque,
                styles_fmt,
                events_fmt,
            ) = ssa_format.parse_ssa(text)
            return SubtitleDocument(
                cues,
                sub_format=fmt,
                encoding=encoding,
                styles=styles,
                info=info,
                fonts_opaque=fonts_opaque,
                styles_format_line=styles_fmt,
                events_format_line=events_fmt,
            )
        if detected == "vtt":
            return SubtitleDocument(
                ssa_format.parse_vtt(text), sub_format=fmt, encoding=encoding
            )
        if detected == "microdvd":
            return SubtitleDocument(
                ssa_format.parse_microdvd(text), sub_format=fmt, encoding=encoding
            )
        if detected == "srt":
            return SubtitleDocument(
                list(srt_format.parse(text, tolerant=not strict)),
                sub_format=fmt,
                encoding=encoding,
            )
    raise NotImplementedError("unsupported format: %s" % fmt)


def compose_document(doc: SubtitleDocument, out_format: Optional[str]) -> str:
    """Serialize *doc*, converting to *out_format* when it differs."""
    if out_format is None or out_format == "":
        out_format = doc.sub_format
    if out_format in ("ssa", "ass"):
        return ssa_format.compose_ssa(
            list(doc.cues),
            out_format,
            styles=doc.styles,
            info=doc.info,
            fonts_opaque=doc.fonts_opaque,
            styles_format=doc.styles_format_line,
            events_format=doc.events_format_line,
        )
    if out_format == "vtt":
        return ssa_format.compose_vtt(list(doc.cues))
    if out_format == "srt":
        return srt_format.compose(_to_text_cues(doc.cues))
    if out_format == "sub":
        # a "sub"-declared document that was actually SSA/VTT still writes
        # MicroDVD here; declared-format documents round-trip losslessly
        return ssa_format.compose_microdvd(list(doc.cues))
    raise NotImplementedError("unsupported output format: %s" % out_format)


def _to_text_cues(cues: List[Cue]) -> List[Cue]:
    """Convert any SSA-payload cues to plain-text payloads for SRT emission."""
    from ffsubsync_tpu_torch.subs.model import SrtRecord, SsaEventRecord

    out = []
    for cue in cues:
        if isinstance(cue.inner, SsaEventRecord):
            out.append(
                Cue(
                    start_us=cue.start_us,
                    end_us=cue.end_us,
                    inner=SrtRecord(
                        index=None,
                        content=ssa_format.ssa_event_text_to_plain(cue.inner.text),
                    ),
                )
            )
        else:
            out.append(cue)
    return out
