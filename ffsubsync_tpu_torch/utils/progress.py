# -*- coding: utf-8 -*-
"""Progress reporting for speech extraction.

``ProgressInfo`` is public API for library embedders (parity:
ffsubsync/speech_transformers.py:38-53 and README.md:145-167). The
``ProgressReporter`` bundles the reference's four concurrent progress modes
(tqdm bar, host-app callback, vlc-mode percent prints, gui-mode stderr
redirection — speech_transformers.py:688-741) into one object the audio
decoder drives per chunk.
"""
import io
import logging
import sys
from typing import Callable, NamedTuple, Optional

from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class ProgressInfo(NamedTuple):
    """Progress emitted to a ``progress_handler`` during speech extraction.

    ``processed_seconds`` is the amount of reference audio decoded so far and
    ``total_seconds`` is the reference's total duration (``None`` when it
    could not be determined). Use :attr:`fraction` for a 0.0-1.0 ratio.
    """

    processed_seconds: float
    total_seconds: Optional[float]

    @property
    def fraction(self) -> Optional[float]:
        if not self.total_seconds:
            return None
        return min(1.0, self.processed_seconds / self.total_seconds)


class ProgressReporter:
    """Drives all progress channels as audio seconds are processed."""

    def __init__(
        self,
        total_seconds: Optional[float],
        progress_handler: Optional[Callable[[ProgressInfo], None]] = None,
        vlc_mode: bool = False,
        gui_mode: bool = False,
    ) -> None:
        self.total_seconds = total_seconds
        self.progress_handler = progress_handler
        self.vlc_mode = vlc_mode
        self.gui_mode = gui_mode
        self.processed_seconds = 0.0
        self._pbar = None
        self._pbar_output: Optional[io.StringIO] = None
        self._stderr_redirect = None

    @tracing.spanned("progress")
    def __enter__(self) -> "ProgressReporter":
        if self.gui_mode:
            # capture stray stderr during extraction and re-surface it on
            # stdout each update, where Gooey can display it (parity:
            # speech_transformers.py:688-706, 738-741)
            from contextlib import redirect_stderr

            self._pbar_output = io.StringIO()
            self._stderr_redirect = redirect_stderr(self._pbar_output)
            self._stderr_redirect.__enter__()
        else:
            self._stderr_redirect = None
        try:
            import tqdm

            extra = {}
            if self.gui_mode:
                extra["file"] = sys.stdout
            self._pbar = tqdm.tqdm(
                total=self.total_seconds, disable=self.vlc_mode, **extra
            )
        except ImportError:  # tqdm is cosmetic; never required
            self._pbar = None
        return self

    @tracing.spanned("progress")
    def __exit__(self, exc_type=None, exc=None, tb=None) -> None:
        if self._pbar is not None:
            self._pbar.close()
        if self._stderr_redirect is not None:
            self._stderr_redirect.__exit__(exc_type, exc, tb)
            # re-surface anything captured after the last update() — in
            # particular error text written just before extraction raised,
            # which would otherwise be swallowed with the redirect
            tail = self._pbar_output.getvalue() if self._pbar_output else ""
            if tail:
                print(tail)

    @tracing.spanned("progress")
    def update(self, new_seconds: float) -> None:
        if (
            self.total_seconds is not None
            and self.processed_seconds + new_seconds > self.total_seconds
        ):
            new_seconds = self.total_seconds - self.processed_seconds
        self.processed_seconds += new_seconds
        if self._pbar is not None:
            self._pbar.update(new_seconds)
        if self.progress_handler is not None:
            try:
                self.progress_handler(
                    ProgressInfo(
                        processed_seconds=self.processed_seconds,
                        total_seconds=self.total_seconds,
                    )
                )
            except Exception as e:
                # a host-supplied callback must never break syncing
                logger.warning("progress_handler raised: %s", e)
        if self.vlc_mode and self.total_seconds is not None:
            print("%d" % int(self.processed_seconds * 100.0 / self.total_seconds))
            sys.stdout.flush()
        if self.gui_mode and self._pbar_output is not None:
            # drain whatever stderr the redirect captured since the last
            # update (read() would start at the post-write position and
            # return nothing); gui mode runs python -u, so no explicit flush
            captured = self._pbar_output.getvalue()
            if captured:
                self._pbar_output.seek(0)
                self._pbar_output.truncate(0)
                print(captured)
