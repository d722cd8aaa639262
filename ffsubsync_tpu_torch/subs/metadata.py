# -*- coding: utf-8 -*-
"""Non-dialogue ("metadata") cue heuristic.

Cues that carry no speech — bracketed sound descriptions, music-note lines,
translator credits — must not contribute to the 100 Hz speech signal. The
rules replicate the reference's ``_is_metadata``
(ffsubsync/speech_transformers.py:906-943):

- markup tags (``<i>``, ``<font ...>``) are stripped before classification, so
  ``<i>[music]</i>`` is recognized as non-dialogue while ``<i>Hello?</i>``
  stays dialogue;
- a line fully enclosed in paired brackets (incl. full-width CJK pairs) is
  metadata;
- a line of only music/sound symbols is metadata;
- the first and last cue get extra scrutiny: containing "english" or " - "
  marks them as credits-style metadata.
"""
import re
from typing import Dict

_PAIRED_NESTER: Dict[str, str] = {
    "(": ")",
    "{": "}",
    "[": "]",
    "（": "）",
    "【": "】",
    "「": "」",
}

_MARKUP_TAG = re.compile(r"<[^>]+>")

_NON_DIALOGUE_SYMBOLS = frozenset("♪♫♬♩🎵🎶")


def is_metadata(content: str, is_beginning_or_end: bool) -> bool:
    content = _MARKUP_TAG.sub("", content).strip()
    if len(content) == 0:
        return True
    if (
        content[0] in _PAIRED_NESTER
        and content[-1] == _PAIRED_NESTER[content[0]]
    ):
        return True
    if all(ch.isspace() or ch in _NON_DIALOGUE_SYMBOLS for ch in content):
        return True
    if is_beginning_or_end:
        if "english" in content.lower():
            return True
        if " - " in content:
            return True
    return False
