# -*- coding: utf-8 -*-
"""Host milliseconds per request inside the media layer's WAV reader (each step of media.wav.WavReader.iter_chunks), summed over its threads."""


def read(run):
    spans = run.spans_of("read")
    if not spans or not run.requests:
        return None
    return 1e3 * sum(t1 - t0 for _l, _k, _tid, t0, t1 in spans) / len(run.requests)
