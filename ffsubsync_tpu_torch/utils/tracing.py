# -*- coding: utf-8 -*-
"""Spans of the port's layers, on the clock of the profiler's trace.

A span names one stretch of a request's host work::

    with tracing.span("parse"):
        ...

Tracing is **on** inside ``with tracing.recording() as rec:`` and while a
``torch.profiler`` records on the thread that opens the span; it is **off**
otherwise, where a span records nothing and opens nothing. While on, each
span is kept as a :class:`Span` (name, id, parent id, request id, system
thread id, ``t0`` and ``t1`` on ``time.perf_counter``). Where a profiler
records on the span's thread, the span also opens
``torch.profiler.record_function(name)``: the profiler's Chrome trace then
shows it as a ``user_annotation`` range, and the kernels launched inside it
on a ``gpu_user_annotation`` row of the same name. (Nothing else records
those ranges, and each costs tens of microseconds.)

The roots ``sync`` (``sync.run``) and ``batch`` (``batch.sync_batch``) each
open a request (``span(name, root=True)``). Every span beneath a root
carries the root's request id, on every thread the request hands work to
through :func:`bind` (a ``ThreadPoolExecutor`` does not copy the caller's
context, and a profiler records on the thread that started it only, so a
worker learns from its copied context that tracing is on).

Spans are kept in one bounded store (:data:`LIMIT`); spans past the bound
are counted in ``dropped`` and not kept. :func:`count` adds to a named
counter of the same store, on or off (``pcm_join.views``,
``pcm_join.copies``, ``stage.calls``, ``stage.ranges``, ``net_load.calls``,
``net_load.reads``: dotted names, which no span takes). :func:`spans`,
:func:`counts` and :func:`reset` read and clear the store that profiled
runs fill; :func:`recording` gives its block a store of its own.
"""
import array
import contextlib
import contextvars
import functools
import itertools
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

LIMIT = 200_000


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int  # system thread id, as the profiler's trace names threads
    t0: float
    t1: float


class Store:
    """The spans kept (at most :data:`LIMIT`, as it reads when the store is
    made), the count of each name closed, the counters of :func:`count`,
    and the number of spans dropped past the limit. The spans are kept as
    flat arrays, so that a kept span adds no object for the garbage
    collector to walk; :attr:`spans` builds the :class:`Span` tuples when
    first read."""

    def __init__(self) -> None:
        self.limit = LIMIT
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self._names: List[str] = []
        self._ids = array.array("q")  # id, parent, request, thread (0: none)
        self._times = array.array("d")  # t0, t1
        self._read: List[Span] = []  # the spans built so far
        self._lock = threading.Lock()

    def add(self, name: str, id: int, parent: Optional[int], request: Optional[int],
            thread: int, t0: float, t1: float) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + 1
            if len(self._names) < self.limit:
                self._names.append(name)
                self._ids.extend((id, parent or 0, request or 0, thread))
                self._times.extend((t0, t1))
            else:
                self.dropped += 1

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            ids, times, read = self._ids, self._times, self._read
            read.extend(Span(self._names[i], ids[4 * i], ids[4 * i + 1] or None,
                             ids[4 * i + 2] or None, ids[4 * i + 3], times[2 * i],
                             times[2 * i + 1])
                        for i in range(len(read), len(self._names)))
            return read


_store = Store()
_thread = threading.local()  # .id: the thread's system id, read once
_recording = 0  # open recording() blocks
_switch = threading.Lock()  # guards the two above
_ids = itertools.count(1)
# (request id, span id) of the innermost span open in this context
_open: contextvars.ContextVar = contextvars.ContextVar("ffs_tracing_open", default=None)
_OFF = contextlib.nullcontext()


_profiler_enabled: Optional[Callable[[], bool]] = None  # torch's, once torch is imported


def _profiling() -> bool:
    """Whether a profiler records on this thread (none can before torch is
    imported)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


def _thread_id() -> int:
    tid = getattr(_thread, "id", None)
    if tid is None:  # a system call, slow on some hosts: once per thread
        tid = _thread.id = threading.get_native_id()
    return tid


class _Span:
    __slots__ = ("name", "root", "id", "parent", "request", "t0", "token", "range")

    def __init__(self, name: str, root: bool) -> None:
        self.name, self.root = name, root

    def __enter__(self) -> "_Span":
        self.id = next(_ids)
        outer = _open.get()
        self.parent = outer[1] if outer is not None else None
        if self.root:
            self.request = self.id
        else:
            self.request = outer[0] if outer is not None else None
        self.token = _open.set((self.request, self.id))
        self.range = None
        if _profiling():
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        # the clock read inside the range: the span times its block alone
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.reset(self.token)
        _store.add(self.name, self.id, self.parent, self.request, _thread_id(), self.t0, t1)


def span(name: str, root: bool = False):
    """A context manager timing its block as ``name``; with ``root`` it
    opens a new request. Off, it is a shared no-op."""
    if _open.get() is None and not _recording and not _profiling():
        return _OFF
    return _Span(name, root)


def spanned(name: str, root: bool = False) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)
        return call
    return wrap


def bind(fn: Callable) -> Callable:
    """``fn`` to run in a copy of the caller's context, so that the spans it
    opens on another thread belong to the caller's request (bind once per
    task: a context runs on one thread at a time)."""
    return functools.partial(contextvars.copy_context().run, fn)


@contextlib.contextmanager
def recording() -> Iterator[Store]:
    """Tracing on for the block, into a store of its own, which it yields:
    ``rec.spans``, ``rec.counts``, ``rec.dropped``. Blocks nest; the
    innermost open one takes the spans."""
    global _store, _recording
    store = Store()
    with _switch:
        saved, _store = _store, store
        _recording += 1
    try:
        yield store
    finally:
        with _switch:
            _recording -= 1
            _store = saved


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``, whether tracing is on or off."""
    store = _store
    with store._lock:
        store.counters[name] = store.counters.get(name, 0) + n


def spans() -> List[Span]:
    """The spans kept since the last :func:`reset` (or inside the open
    :func:`recording` block)."""
    return list(_store.spans)


def counts() -> Dict[str, int]:
    """The count of each span name and each :func:`count` counter since the
    last :func:`reset` (or inside the open :func:`recording` block), the
    spans dropped past the bound, and the kernel launch counters of
    ``ops/frontend`` and ``ops/scan`` (since the process started)."""
    from ffsubsync_tpu_torch.ops import frontend, scan

    with _store._lock:
        out = dict(_store.counts)
        out.update(_store.counters)
        out["dropped"] = _store.dropped
    out["fused_frontend.launches"] = frontend.fused_frontend.launches
    out["scan.launches"] = scan.launches
    return out


def reset() -> None:
    """Empty the store that spans outside a :func:`recording` block go to."""
    global _store
    with _switch:
        if not _recording:
            _store = Store()
