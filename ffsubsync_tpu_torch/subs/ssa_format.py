# -*- coding: utf-8 -*-
"""In-tree SSA/ASS, WebVTT, and MicroDVD parsers / composers.

The reference handles these formats through the third-party ``pysubs2``
library, with format auto-detection (ffsubsync/subtitle_parser.py:119-120:
``pysubs2.SSAFile.from_string`` is used for "ass", "ssa", "sub" and "vtt"
inputs alike) and SSA styles / script-info / fonts preservation
(:125-134, generic_subtitles.py:141-150). This module is an original
implementation covering the same surface:

- :func:`detect_format` sniffs the actual format of the text;
- SSA/ASS parsing keeps styles, script info, fonts and the source column
  layout so transformations round-trip losslessly;
- composers exist for ssa, ass, vtt and microdvd outputs, plus conversion of
  SSA events to plain text for SRT emission (override tags ``{\\...}``
  stripped, ``\\N``/``\\n`` mapped to newlines, as pysubs2's SRT writer does).
"""
import logging
import re
from typing import Any, Dict, List, Optional, Tuple

from ffsubsync_tpu_torch.subs.model import Cue, SrtRecord, SsaEventRecord

logger = logging.getLogger(__name__)

US_PER_HOUR = 3_600_000_000
US_PER_MINUTE = 60_000_000
US_PER_SECOND = 1_000_000
US_PER_MS = 1_000
US_PER_CS = 10_000

DEFAULT_MICRODVD_FPS = 23.976

_SECTION_RE = re.compile(r"^\s*\[([^\]]+)\]\s*$")
_SSA_TIME_RE = re.compile(r"^\s*(-?\d+):(\d{1,2}):(\d{1,2})[.:](\d{1,2})\s*$")
_VTT_TIME_RE = re.compile(r"^(?:(\d+):)?(\d{1,2}):(\d{1,2})[.,](\d{1,3})$")
_MICRODVD_RE = re.compile(r"^\{(-?\d+)\}\{(-?\d+)\}(.*)$")
_OVERRIDE_TAG_RE = re.compile(r"\{[^}]*\}")

DEFAULT_EVENTS_FORMAT = [
    "Layer",
    "Start",
    "End",
    "Style",
    "Name",
    "MarginL",
    "MarginR",
    "MarginV",
    "Effect",
    "Text",
]

DEFAULT_STYLES_FORMAT_ASS = [
    "Name", "Fontname", "Fontsize", "PrimaryColour", "SecondaryColour",
    "OutlineColour", "BackColour", "Bold", "Italic", "Underline", "StrikeOut",
    "ScaleX", "ScaleY", "Spacing", "Angle", "BorderStyle", "Outline", "Shadow",
    "Alignment", "MarginL", "MarginR", "MarginV", "Encoding",
]

DEFAULT_ASS_STYLE = {
    "Name": "Default", "Fontname": "Arial", "Fontsize": "20",
    "PrimaryColour": "&H00FFFFFF", "SecondaryColour": "&H000000FF",
    "OutlineColour": "&H00000000", "BackColour": "&H00000000",
    "Bold": "0", "Italic": "0", "Underline": "0", "StrikeOut": "0",
    "ScaleX": "100", "ScaleY": "100", "Spacing": "0", "Angle": "0",
    "BorderStyle": "1", "Outline": "2", "Shadow": "2", "Alignment": "2",
    "MarginL": "10", "MarginR": "10", "MarginV": "10", "Encoding": "1",
}


def detect_format(text: str) -> Optional[str]:
    """Sniff the actual subtitle format of *text*.

    Returns one of "ass", "ssa", "vtt", "microdvd", "srt", or None. Mirrors
    pysubs2's autodetection role at the reference's parse dispatch.
    """
    stripped = text.lstrip("﻿\r\n \t")
    low = stripped.lower()
    if low.startswith("webvtt"):
        return "vtt"
    for m in _SECTION_RE.finditer(text):
        section = m.group(1).strip().lower()
        if section == "v4+ styles":
            return "ass"
        if section == "v4 styles":
            return "ssa"
        if section == "script info":
            # defer: explicit styles section wins, else decide by ScriptType
            continue
    if "[script info]" in low:
        return "ass" if "v4.00+" in low else "ssa"
    if _MICRODVD_RE.match(stripped.split("\n", 1)[0].strip()):
        return "microdvd"
    if "-->" in text:
        return "srt"
    return None


def _ssa_time_to_us(text: str) -> int:
    m = _SSA_TIME_RE.match(text)
    if m is None:
        raise ValueError("bad SSA timestamp: %r" % text)
    h, mi, s, frac = m.groups()
    # fractional field is centiseconds when 2 digits (the standard), but some
    # files carry 1; normalize by right-padding to 2
    cs = int(frac.ljust(2, "0")[:2])
    return (
        int(h) * US_PER_HOUR
        + int(mi) * US_PER_MINUTE
        + int(s) * US_PER_SECOND
        + cs * US_PER_CS
    )


def format_ssa_timestamp(us: int) -> str:
    """``H:MM:SS.cc`` with centiseconds truncated from microseconds."""
    if us < 0:
        us = 0  # SSA cannot express negative times
    h, rem = divmod(us, US_PER_HOUR)
    mi, rem = divmod(rem, US_PER_MINUTE)
    s, rem = divmod(rem, US_PER_SECOND)
    cs = rem // US_PER_CS
    return "%d:%02d:%02d.%02d" % (h, mi, s, cs)


def parse_ssa(
    text: str,
) -> Tuple[
    List[Cue],
    Dict[str, Dict[str, str]],
    Dict[str, str],
    Any,
    Optional[List[str]],
    Optional[List[str]],
]:
    """Parse SSA/ASS text.

    Returns (cues, styles, info, fonts_opaque, styles_format, events_format).
    ``fonts_opaque`` carries the raw lines of a ``[Fonts]`` section, if any, so
    embedded fonts survive a round trip without being interpreted.
    """
    styles: Dict[str, Dict[str, str]] = {}
    info: Dict[str, str] = {}
    fonts_lines: List[str] = []
    cues: List[Cue] = []
    styles_format: Optional[List[str]] = None
    events_format: Optional[List[str]] = None
    section = None
    for rawline in text.split("\n"):
        line = rawline.rstrip("\r")
        sec_m = _SECTION_RE.match(line)
        if sec_m is not None:
            section = sec_m.group(1).strip().lower()
            continue
        if not line.strip() or line.lstrip().startswith(";"):
            continue
        if section == "script info":
            if ":" in line:
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
        elif section in ("v4+ styles", "v4 styles", "v4 styles+"):
            key, _, value = line.partition(":")
            key = key.strip().lower()
            if key == "format":
                styles_format = [f.strip() for f in value.split(",")]
            elif key == "style":
                fmt = styles_format or DEFAULT_STYLES_FORMAT_ASS
                fields = value.split(",", len(fmt) - 1)
                style = {
                    name: fields[i].strip() if i < len(fields) else ""
                    for i, name in enumerate(fmt)
                }
                styles[style.get("Name", "Default")] = style
        elif section == "events":
            key, _, value = line.partition(":")
            kind = key.strip()
            lkind = kind.lower()
            if lkind == "format":
                events_format = [f.strip() for f in value.split(",")]
                continue
            if lkind not in ("dialogue", "comment"):
                continue
            fmt = events_format or DEFAULT_EVENTS_FORMAT
            fields = value.split(",", len(fmt) - 1)
            if len(fields) < len(fmt):
                logger.warning("skipping malformed %s line: %r", kind, line[:80])
                continue
            record_fields: Dict[str, str] = {}
            start_us = end_us = None
            event_text = ""
            for i, name in enumerate(fmt):
                val = fields[i]
                if name == "Start":
                    start_us = _ssa_time_to_us(val)
                elif name == "End":
                    end_us = _ssa_time_to_us(val)
                elif name == "Text":
                    event_text = val
                else:
                    record_fields[name] = val.strip()
            if start_us is None or end_us is None:
                continue
            if lkind == "comment":
                # comments are not displayed; keep them out of the cue list
                # (pysubs2 keeps them as events, but they never carry timing
                # signal and ffsubsync never inspects them)
                continue
            cues.append(
                Cue(
                    start_us=start_us,
                    end_us=end_us,
                    inner=SsaEventRecord(
                        text=event_text, kind="Dialogue", fields=record_fields
                    ),
                )
            )
        elif section == "fonts":
            fonts_lines.append(line)
    fonts_opaque: Any = fonts_lines or None
    return cues, styles, info, fonts_opaque, styles_format, events_format


def ssa_event_text_to_plain(text: str) -> str:
    """SSA event text → plain text: strip override tags, map \\N,\\n,\\h."""
    text = _OVERRIDE_TAG_RE.sub("", text)
    text = text.replace("\\N", "\n").replace("\\n", "\n").replace("\\h", " ")
    return text


def plain_text_to_ssa(text: str) -> str:
    """Plain (possibly HTML-tagged SRT) text → SSA event text."""
    replacements = [
        ("<i>", "{\\i1}"), ("</i>", "{\\i0}"),
        ("<b>", "{\\b1}"), ("</b>", "{\\b0}"),
        ("<u>", "{\\u1}"), ("</u>", "{\\u0}"),
    ]
    for old, new in replacements:
        text = text.replace(old, new)
    text = re.sub(r"</?font[^>]*>", "", text)
    return text.replace("\n", "\\N")


def compose_ssa(
    cues: List[Cue],
    out_format: str,
    styles: Optional[Dict[str, Dict[str, str]]] = None,
    info: Optional[Dict[str, str]] = None,
    fonts_opaque: Any = None,
    styles_format: Optional[List[str]] = None,
    events_format: Optional[List[str]] = None,
) -> str:
    """Serialize cues to SSA ("ssa") or ASS ("ass") text."""
    is_ass = out_format == "ass"
    lines: List[str] = ["[Script Info]"]
    out_info = dict(info) if info else {}
    out_info.setdefault("WrapStyle", "0")
    out_info.setdefault("ScaledBorderAndShadow", "yes")
    out_info["ScriptType"] = "v4.00+" if is_ass else "v4.00"
    if "Title" not in out_info:
        out_info["Title"] = "<untitled>"
    for key in ("Title", "ScriptType", "WrapStyle", "ScaledBorderAndShadow"):
        lines.append("{}: {}".format(key, out_info[key]))
    for key, value in out_info.items():
        if key in ("Title", "ScriptType", "WrapStyle", "ScaledBorderAndShadow"):
            continue
        lines.append("{}: {}".format(key, value))
    lines.append("")
    sfmt = styles_format or DEFAULT_STYLES_FORMAT_ASS
    lines.append("[V4+ Styles]" if is_ass else "[V4 Styles]")
    lines.append("Format: " + ", ".join(sfmt))
    out_styles = styles if styles else {"Default": DEFAULT_ASS_STYLE}
    for style in out_styles.values():
        lines.append("Style: " + ",".join(style.get(f, "") for f in sfmt))
    lines.append("")
    if fonts_opaque:
        lines.append("[Fonts]")
        lines.extend(fonts_opaque)
        lines.append("")
    efmt = events_format or DEFAULT_EVENTS_FORMAT
    lines.append("[Events]")
    lines.append("Format: " + ", ".join(efmt))
    for cue in cues:
        rec = cue.inner
        if isinstance(rec, SsaEventRecord):
            fields = dict(rec.fields)
            text = rec.text
            kind = rec.kind
        else:
            fields = {}
            text = plain_text_to_ssa(cue.content)
            kind = "Dialogue"
        parts = []
        for name in efmt:
            if name == "Start":
                parts.append(format_ssa_timestamp(cue.start_us))
            elif name == "End":
                parts.append(format_ssa_timestamp(cue.end_us))
            elif name == "Text":
                parts.append(text)
            elif name in ("Layer", "Marked"):
                parts.append(fields.get(name, "0"))
            elif name == "Style":
                parts.append(fields.get(name, "Default"))
            elif name.startswith("Margin"):
                parts.append(fields.get(name, "0"))
            else:
                parts.append(fields.get(name, ""))
        lines.append("{}: {}".format(kind, ",".join(parts)))
    return "\n".join(lines) + "\n"


def _vtt_time_to_us(text: str) -> int:
    m = _VTT_TIME_RE.match(text.strip())
    if m is None:
        raise ValueError("bad VTT timestamp: %r" % text)
    h, mi, s, ms = m.groups()
    return (
        int(h or 0) * US_PER_HOUR
        + int(mi) * US_PER_MINUTE
        + int(s) * US_PER_SECOND
        + int(ms.ljust(3, "0")[:3]) * US_PER_MS
    )


def format_vtt_timestamp(us: int) -> str:
    if us < 0:
        us = 0
    h, rem = divmod(us, US_PER_HOUR)
    mi, rem = divmod(rem, US_PER_MINUTE)
    s, rem = divmod(rem, US_PER_SECOND)
    ms = rem // US_PER_MS
    return "%02d:%02d:%02d.%03d" % (h, mi, s, ms)


def parse_vtt(text: str) -> List[Cue]:
    """Parse WebVTT text into SRT-payload cues (settings kept as proprietary)."""
    if text.startswith("﻿"):
        text = text[1:]
    cues: List[Cue] = []
    lines = text.split("\n")
    i = 0
    n = len(lines)
    # skip the WEBVTT header line and any header metadata until a blank line
    while i < n and lines[i].strip():
        i += 1
    while i < n:
        while i < n and not lines[i].strip():
            i += 1
        if i >= n:
            break
        block_start = i
        # skip NOTE/STYLE/REGION blocks
        head = lines[i].strip()
        if head.startswith(("NOTE", "STYLE", "REGION")):
            while i < n and lines[i].strip():
                i += 1
            continue
        timing_idx = None
        for probe in range(i, min(i + 2, n)):
            if "-->" in lines[probe]:
                timing_idx = probe
                break
        if timing_idx is None:
            while i < n and lines[i].strip():
                i += 1
            logger.warning("skipping malformed vtt block: %r",
                           "\n".join(lines[block_start:i])[:80])
            continue
        timing_line = lines[timing_idx]
        left, _, right = timing_line.partition("-->")
        right_parts = right.strip().split(None, 1)
        settings = right_parts[1] if len(right_parts) > 1 else ""
        try:
            start_us = _vtt_time_to_us(left.strip())
            end_us = _vtt_time_to_us(right_parts[0])
        except (ValueError, IndexError):
            while i < n and lines[i].strip():
                i += 1
            logger.warning("skipping malformed vtt timing: %r", timing_line[:80])
            continue
        i = timing_idx + 1
        content_lines: List[str] = []
        while i < n and lines[i].strip():
            content_lines.append(lines[i])
            i += 1
        cues.append(
            Cue(
                start_us=start_us,
                end_us=end_us,
                inner=SrtRecord(
                    index=None,
                    content="\n".join(content_lines),
                    proprietary=settings,
                ),
            )
        )
    return cues


def compose_vtt(cues: List[Cue]) -> str:
    blocks = ["WEBVTT", ""]
    for cue in sorted(cues, key=lambda c: (c.start_us, c.end_us)):
        rec = cue.inner
        if isinstance(rec, SsaEventRecord):
            content = ssa_event_text_to_plain(rec.text)
            settings = ""
        else:
            content = rec.content
            settings = rec.proprietary if isinstance(rec, SrtRecord) else ""
        timing = "{} --> {}".format(
            format_vtt_timestamp(cue.start_us), format_vtt_timestamp(cue.end_us)
        )
        if settings:
            timing = "{} {}".format(timing, settings)
        blocks.append(timing)
        blocks.append(content)
        blocks.append("")
    return "\n".join(blocks)


def parse_microdvd(text: str, fps: Optional[float] = None) -> List[Cue]:
    """Parse MicroDVD ``{start}{end}text`` lines (frame-based timing).

    The frame rate comes from the conventional ``{1}{1}<fps>`` header line if
    present, else *fps*, else 23.976 (with a warning).
    """
    lines = [ln for ln in text.split("\n") if ln.strip()]
    cues: List[Cue] = []
    detected_fps = fps
    start_idx = 0
    if lines:
        m = _MICRODVD_RE.match(lines[0].strip())
        if m and m.group(1) == "1" and m.group(2) == "1":
            try:
                detected_fps = float(m.group(3).strip().replace(",", "."))
                start_idx = 1
            except ValueError:
                pass
    if detected_fps is None:
        detected_fps = DEFAULT_MICRODVD_FPS
        logger.warning(
            "no frame rate found in MicroDVD file; assuming %s fps",
            DEFAULT_MICRODVD_FPS,
        )
    for line in lines[start_idx:]:
        m = _MICRODVD_RE.match(line.strip())
        if m is None:
            logger.warning("skipping malformed microdvd line: %r", line[:80])
            continue
        f0, f1, payload = int(m.group(1)), int(m.group(2)), m.group(3)
        # strip leading formatting directives like {y:i} / {c:$0000ff}
        content = _OVERRIDE_TAG_RE.sub("", payload).replace("|", "\n")
        cues.append(
            Cue(
                start_us=round(f0 / detected_fps * US_PER_SECOND),
                end_us=round(f1 / detected_fps * US_PER_SECOND),
                inner=SrtRecord(index=None, content=content),
            )
        )
    return cues


def compose_microdvd(cues: List[Cue], fps: float = DEFAULT_MICRODVD_FPS) -> str:
    lines = ["{1}{1}%.3f" % fps]
    for cue in sorted(cues, key=lambda c: (c.start_us, c.end_us)):
        content = cue.content
        if isinstance(cue.inner, SsaEventRecord):
            content = ssa_event_text_to_plain(cue.inner.text)
        lines.append(
            "{%d}{%d}%s"
            % (
                round(cue.start_us / US_PER_SECOND * fps),
                round(cue.end_us / US_PER_SECOND * fps),
                content.replace("\n", "|"),
            )
        )
    return "\n".join(lines) + "\n"
