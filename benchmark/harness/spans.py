# -*- coding: utf-8 -*-
"""Spans of the program's layers, recorded from outside the program.

:class:`Recorder` replaces a few of the port's functions with wrappers
that time each call on the host clock and hand it on unchanged (the calls
the layers make into each other; the program is not edited):

- ``read``: each step of ``media.wav.WavReader.iter_chunks`` (the media
  layer's reader);
- ``stage``: ``ops.vad.stage_to_device`` (host staging and the queued copy);
- ``vad``: ``ops.vad._vad_program`` (the enqueue of one VAD program);
- ``align``: ``sync.align_candidates`` and
  ``parallel.batch.BatchAligner.align_batch`` (the search, with its wait
  for the labels).

Each span is kept as (layer, request, thread, start, end), the thread by
its system id, as the profiler's trace names threads; the trace's reader
places the spans of every thread on the trace's clock (the profiler's own
ranges are recorded on the thread that started it only). The
searches' inputs and answers are kept for the correctness check: the
candidates and alignments of every request, the labels of the requests the
check samples.
"""
import threading
import time


class Recorder:
    def __init__(self):
        self.spans = []  # (layer, request, system thread id, t0, t1)
        self.programs = []  # (request, windows T, valid windows)
        self.searches = {}  # request -> [(refs or None, candidates per ref, alignments per ref)]
        self.request = None
        self.keep_labels = False
        self._lock = threading.Lock()
        self._real = []

    # -- bookkeeping -------------------------------------------------------

    def _span(self, layer, t0, t1):
        with self._lock:
            self.spans.append((layer, self.request, threading.get_native_id(), t0, t1))

    def _timed(self, layer, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._span(layer, t0, time.perf_counter())

    def _patch(self, owner, name, wrapper):
        self._real.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    def _keep_search(self, refs, candidates, out):
        with self._lock:
            self.searches.setdefault(self.request, []).append(
                (refs if self.keep_labels else None, candidates, out))

    # -- the wrappers --------------------------------------------------------

    def __enter__(self):
        from ffsubsync_tpu_torch import sync
        from ffsubsync_tpu_torch.media.wav import WavReader
        from ffsubsync_tpu_torch.ops import vad
        from ffsubsync_tpu_torch.parallel.batch import BatchAligner

        rec = self
        real_iter = WavReader.iter_chunks
        real_stage, real_program = vad.stage_to_device, vad._vad_program
        real_align, real_batch = sync.align_candidates, BatchAligner.align_batch

        def iter_chunks(reader, *args, **kwargs):
            it = real_iter(reader, *args, **kwargs)
            while True:
                try:
                    chunk = rec._timed("read", next, it)
                except StopIteration:
                    return
                yield chunk

        def stage_to_device(*args, **kwargs):
            return rec._timed("stage", real_stage, *args, **kwargs)

        def vad_program(framed, window, frame_rate, n_valid, *args, **kwargs):
            with rec._lock:
                rec.programs.append((rec.request, int(framed.shape[0]), int(n_valid),
                                     int(framed.shape[1]) * framed.element_size(), window,
                                     frame_rate))
            return rec._timed("vad", real_program, framed, window, frame_rate, n_valid,
                              *args, **kwargs)

        def align_candidates(ref, candidates, *args, **kwargs):
            out = rec._timed("align", real_align, ref, candidates, *args, **kwargs)
            rec._keep_search([ref], [list(candidates)], [out])
            return out

        def align_batch(aligner, refs, candidates, **kwargs):
            out = rec._timed("align", real_batch, aligner, refs, candidates, **kwargs)
            rec._keep_search(list(refs), [list(c) for c in candidates], out)
            return out

        self._patch(WavReader, "iter_chunks", iter_chunks)
        self._patch(vad, "stage_to_device", stage_to_device)
        self._patch(vad, "_vad_program", vad_program)
        self._patch(sync, "align_candidates", align_candidates)
        self._patch(BatchAligner, "align_batch", align_batch)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._real):
            setattr(owner, name, real)
        self._real = []
        return False

    # -- per request ---------------------------------------------------------

    def begin(self, k, keep_labels):
        self.request, self.keep_labels = k, keep_labels

    def end(self):
        self.request, self.keep_labels = None, False


def counters():
    """The program's own launch counters: the frontend kernel's and the scan
    kernel's."""
    from ffsubsync_tpu_torch.ops import frontend, scan

    return {"frontend": frontend.fused_frontend.launches, "scan": scan.launches}
