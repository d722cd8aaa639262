# -*- coding: utf-8 -*-
"""Video/audio reference → 100 Hz speech signal (the decode path).

Counterpart of ``ffsubsync_tpu/media/audio.py::VideoSpeechSource``, bound
to this port's detectors (:func:`ffsubsync_tpu_torch.ops.vad.make_detector`)
on an explicit ``device``. ffmpeg decodes containers to s16le PCM on a pipe;
WAV files are read in-process (``ffsubsync_tpu_torch.media.wav``). In buffered
mode (the default) PCM is dispatched to the device in pipeline chunks as
it streams in, and the labels stay on the device for the aligner. With
``FFS_TPU_SP_VAD=1`` and at least two GPUs, the whole buffer instead runs
as one sequence-parallel call (:mod:`ffsubsync_tpu_torch.parallel.
vad_shard`); the chunked detector stays for the streaming spill.
"""
import logging
import os
import subprocess
import tempfile
from datetime import timedelta
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ffsubsync_tpu_torch.constants import is_remote_url
from ffsubsync_tpu_torch.media.ffmpeg import ffmpeg_bin_path, probe_duration, subprocess_args
from ffsubsync_tpu_torch.media.wav import WavReader, is_wav_file
from ffsubsync_tpu_torch.utils.progress import ProgressInfo, ProgressReporter
from ffsubsync_tpu_torch.ops.vad import _pipeline_chunk_samples, make_detector
from ffsubsync_tpu_torch.parallel.vad_shard import maybe_sharded_detector

logger = logging.getLogger(__name__)

WINDOWS_PER_BUFFER = 10000  # ~100 s of audio per decoded read


def _join_pcm_parts(parts):
    """One contiguous buffer from accumulated PCM chunks (a single part
    passes through untouched: the zero-copy WAV case)."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts)
    return b"".join(parts)


class VideoSpeechSource:
    """Speech extraction from a video/audio reference."""

    def __init__(
        self,
        vad: str,
        sample_rate: int,
        frame_rate: int,
        non_speech_label: float,
        device: torch.device,
        start_seconds: int = 0,
        ffmpeg_path: Optional[str] = None,
        ref_stream: Optional[str] = None,
        vlc_mode: bool = False,
        gui_mode: bool = False,
        max_duration_seconds: Optional[float] = None,
        extract_audio_first: bool = False,
        progress_handler: Optional[Callable[[ProgressInfo], None]] = None,
    ) -> None:
        self.vad = vad
        self.sample_rate = sample_rate
        self.frame_rate = frame_rate
        self._non_speech_label = non_speech_label
        self.device = device
        self.start_seconds = start_seconds
        self.ffmpeg_path = ffmpeg_path
        self.ref_stream = ref_stream
        self.vlc_mode = vlc_mode
        self.gui_mode = gui_mode
        self.max_duration_seconds = max_duration_seconds
        self.extract_audio_first = extract_audio_first
        self.progress_handler = progress_handler
        self.video_speech_results_: Optional[Any] = None

    # -- embedded-subtitle fast path ------------------------------------

    def try_fit_using_embedded_subs(self, fname: str) -> None:
        from ffsubsync_tpu_torch.media.embedded import fit_embedded_subs

        self.video_speech_results_ = fit_embedded_subs(
            fname,
            start_seconds=self.start_seconds,
            ref_stream=self.ref_stream,
            gui_mode=self.gui_mode,
            ffmpeg_path=self.ffmpeg_path,
        )

    # -- ffmpeg decode ----------------------------------------------------

    def _decode_rate(self) -> int:
        """ffmpeg is asked for the analysis rate directly."""
        from ffsubsync_tpu_torch.ops.features import analysis_rate

        return analysis_rate(self.frame_rate, self.sample_rate)

    def _build_ffmpeg_args(self, fname: str) -> List[str]:
        ffmpeg_args = [
            ffmpeg_bin_path("ffmpeg", self.gui_mode, ffmpeg_resources_path=self.ffmpeg_path)
        ]
        if self.start_seconds > 0:
            ffmpeg_args.extend(["-ss", str(timedelta(seconds=self.start_seconds))])
        if self.max_duration_seconds is not None:
            ffmpeg_args.extend(["-t", str(timedelta(seconds=self.max_duration_seconds))])
        ffmpeg_args.extend(["-loglevel", "fatal", "-nostdin", "-i", fname])
        if self.ref_stream is not None and self.ref_stream.startswith("0:a:"):
            ffmpeg_args.extend(["-map", self.ref_stream])
        ffmpeg_args.extend(
            [
                "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le",
                "-af", "aresample=async=1", "-ar", str(self._decode_rate()), "-",
            ]
        )
        return ffmpeg_args

    def _extract_audio_to_temp(self, url: str) -> Optional[str]:
        """Copy the reference's audio to a local temp .mka (no re-encode);
        None on failure (the caller then streams the URL directly)."""
        fd, temp_path = tempfile.mkstemp(suffix=".mka")
        os.close(fd)
        ffmpeg_args = [
            ffmpeg_bin_path("ffmpeg", self.gui_mode, ffmpeg_resources_path=self.ffmpeg_path),
            "-loglevel", "fatal", "-nostdin", "-y", "-i", url, "-vn", "-acodec", "copy",
        ]
        if self.max_duration_seconds is not None:
            limit = self.start_seconds + self.max_duration_seconds
            ffmpeg_args.extend(["-t", str(timedelta(seconds=limit))])
        ffmpeg_args.append(temp_path)
        logger.info("extracting audio from remote reference to %s...", temp_path)
        retcode = subprocess.call(ffmpeg_args, **subprocess_args(include_stdout=False))
        if retcode != 0 or not os.path.getsize(temp_path):
            logger.warning(
                "audio extraction failed (ffmpeg returned %d); "
                "falling back to streaming the reference directly",
                retcode,
            )
            try:
                os.remove(temp_path)
            except OSError:
                pass
            return None
        return temp_path

    # -- main entry ------------------------------------------------------

    def fit(self, fname: str, *_: Any) -> "VideoSpeechSource":
        if "subs" in self.vad and (
            self.ref_stream is None or self.ref_stream.startswith("0:s:")
        ):
            try:
                logger.info("Checking video for subtitles stream...")
                self.try_fit_using_embedded_subs(fname)
                logger.info("...success!")
                return self
            except Exception as e:
                logger.info(e)
        temp_audio = None
        if self.extract_audio_first and is_remote_url(fname):
            temp_audio = self._extract_audio_to_temp(fname)
            if temp_audio is not None:
                fname = temp_audio
        try:
            self._fit_using_audio(fname)
        finally:
            if temp_audio is not None and os.path.exists(temp_audio):
                try:
                    os.remove(temp_audio)
                except OSError:
                    logger.warning("failed to remove temp audio file %s", temp_audio)
        return self

    def _use_native_wav(self, fname: str) -> bool:
        return (
            not is_remote_url(fname)
            and os.path.exists(fname)
            and is_wav_file(fname)
            and os.environ.get("FFS_TPU_DISABLE_NATIVE_WAV") != "1"
        )

    def _pcm_rate(self, fname: str) -> int:
        """Rate of the PCM staged for detection: the WAV file's own rate when
        the VAD stack can analyze it as-is, else ``frame_rate`` (WAV) or the
        analysis rate (ffmpeg)."""
        if self._use_native_wav(fname):
            file_rate = WavReader(fname).sample_rate
            if file_rate % self.sample_rate == 0 and self._can_analyze_rate(file_rate):
                return file_rate
            return self.frame_rate
        return self._decode_rate()

    def _can_analyze_rate(self, file_rate: int) -> bool:
        from ffsubsync_tpu_torch.models.neural_vad import has_trained_weights
        from ffsubsync_tpu_torch.ops.features import _MIN_ANALYSIS_RATE, analysis_rate

        rate = analysis_rate(file_rate, self.sample_rate)
        decimate_on = os.environ.get("FFS_TPU_ANALYSIS_DECIMATE", "1") != "0"
        if decimate_on and rate > 2 * _MIN_ANALYSIS_RATE:
            return False  # decimation can't engage (44.1 kHz family)
        if not ("silero" in self.vad or "fused" in self.vad):
            return True
        return has_trained_weights(rate)

    def _iter_pcm_chunks(self, fname: str, bytes_per_buffer: int, pcm_rate: int):
        """Raw PCM chunks: int16 arrays from the WAV reader, bytes from the
        ffmpeg pipe."""
        if self._use_native_wav(fname):
            logger.info("decoding WAV natively (no ffmpeg subprocess)")
            reader = WavReader(fname)
            yield from reader.iter_chunks(
                target_rate=pcm_rate,
                chunk_seconds=float(WINDOWS_PER_BUFFER) / self.sample_rate,
                start_seconds=self.start_seconds,
                max_duration_seconds=self.max_duration_seconds,
            )
            return
        process = subprocess.Popen(
            self._build_ffmpeg_args(fname), **subprocess_args(include_stdout=True)
        )
        try:
            while True:
                in_bytes = process.stdout.read(bytes_per_buffer)
                if not in_bytes:
                    break
                yield in_bytes
        finally:
            process.wait()

    def _probe_total_duration(self, fname: str) -> Optional[float]:
        try:
            if not is_remote_url(fname) and is_wav_file(fname):
                return WavReader(fname).duration_seconds - self.start_seconds
            return (
                probe_duration(fname, self.gui_mode, ffmpeg_resources_path=self.ffmpeg_path)
                - self.start_seconds
            )
        except Exception as e:
            logger.warning(e)
            return None

    def _use_buffered_vad(
        self, total_duration: Optional[float], pcm_rate: Optional[int] = None
    ) -> bool:
        """Buffered mode dispatches pipeline chunks and pulls once; streaming
        mode runs the detector per decoded read in constant memory."""
        if os.environ.get("FFS_TPU_STREAMING_VAD") == "1":
            return False
        max_bytes = int(os.environ.get("FFS_TPU_MAX_BUFFER_BYTES", 4 * 1024**3))
        if total_duration is not None:
            estimated = int(total_duration) * 2 * (pcm_rate or self.frame_rate)
            if estimated > max_bytes:
                logger.info(
                    "reference too long to buffer (%d bytes est.); "
                    "streaming VAD chunk by chunk",
                    estimated,
                )
                return False
        return True

    def _fit_using_audio(self, fname: str) -> None:
        total_duration = self._probe_total_duration(fname)
        if self.max_duration_seconds is not None and total_duration is not None:
            total_duration = min(total_duration, self.max_duration_seconds)
        pcm_rate = self._pcm_rate(fname)
        detector = make_detector(
            self.vad, self.sample_rate, pcm_rate, self._non_speech_label, self.device
        )
        buffered = self._use_buffered_vad(total_duration, pcm_rate)
        sp_detector = None
        if buffered:
            sp_detector = maybe_sharded_detector(
                self.vad, self.sample_rate, pcm_rate, self._non_speech_label, self.device
            )
        max_buffer_bytes = int(os.environ.get("FFS_TPU_MAX_BUFFER_BYTES", 4 * 1024**3))
        bytes_per_frame = 2
        bytes_per_window = bytes_per_frame * pcm_rate // self.sample_rate
        pipeline_bytes = (
            _pipeline_chunk_samples(pcm_rate, self.sample_rate) * bytes_per_frame
        )
        if sp_detector is not None:
            # the sequence-parallel call needs the whole buffer
            pipeline_bytes = 0
        if getattr(detector, "buffers_pcm", False) and total_duration is None:
            # this detector's handles retain the raw PCM (auditok's
            # whole-signal tokenizer), so dispatching would make the spill
            # below unreachable exactly where the cap guards: an unknown
            # duration. Accumulate instead, where the cap can fire.
            pipeline_bytes = 0
        media_bstring: List[Any] = []
        pcm_parts: List[Any] = []
        pending_handles: List[Any] = []
        buffered_bytes = 0
        with ProgressReporter(
            total_duration,
            progress_handler=self.progress_handler,
            vlc_mode=self.vlc_mode,
            gui_mode=self.gui_mode,
        ) as progress:
            for in_bytes in self._iter_pcm_chunks(
                fname, bytes_per_window * WINDOWS_PER_BUFFER, pcm_rate
            ):
                chunk_nbytes = (
                    in_bytes.nbytes if isinstance(in_bytes, np.ndarray) else len(in_bytes)
                )
                progress.update(chunk_nbytes / float(bytes_per_frame) / pcm_rate)
                if buffered:
                    pcm_parts.append(in_bytes)
                    buffered_bytes += chunk_nbytes
                    if pipeline_bytes and buffered_bytes >= pipeline_bytes:
                        pending_handles.append(
                            detector.dispatch_async(_join_pcm_parts(pcm_parts))
                        )
                        pcm_parts = []
                        buffered_bytes = 0
                    elif buffered_bytes > max_buffer_bytes:
                        # the duration probe lied or failed: drain through the
                        # state-carrying detector and keep streaming
                        logger.info(
                            "buffered %d bytes, above the cap; switching to "
                            "streaming VAD",
                            buffered_bytes,
                        )
                        media_bstring.extend(detector(p) for p in pcm_parts)
                        pcm_parts = []
                        buffered = False
                else:
                    media_bstring.append(detector(in_bytes))
        if buffered and sp_detector is not None and pcm_parts:
            media_bstring.append(sp_detector(_join_pcm_parts(pcm_parts)))
        elif buffered and (pending_handles or pcm_parts):
            # a reference shorter than one chunk is one dispatch of the whole
            # buffer: its labels stay on the device, and auditok's gather
            # tokenizes the whole joined signal in one pass
            if pcm_parts:
                pending_handles.append(detector.dispatch_async(_join_pcm_parts(pcm_parts)))
            media_bstring.append(detector.gather(pending_handles))
        if len(media_bstring) == 0:
            raise ValueError(
                "Unable to detect speech. "
                "Perhaps try specifying a different stream / track, or a different vad."
            )
        if len(media_bstring) == 1 and hasattr(media_bstring[0], "padded_values"):
            # the labels stay on the device: the aligner reads them there
            self.video_speech_results_ = media_bstring[0]
            logger.info("total of speech segments: %s", self.video_speech_results_.sum())
        else:
            self.video_speech_results_ = np.concatenate(
                [np.asarray(m, dtype=np.float64) for m in media_bstring]
            )
            logger.info("total of speech segments: %s", np.sum(self.video_speech_results_))

    # -- sync-core accessors ----------------------------------------------

    def transform(self, *_: Any) -> np.ndarray:
        assert self.video_speech_results_ is not None
        if isinstance(self.video_speech_results_, np.ndarray):
            return self.video_speech_results_
        return self.video_speech_results_.materialize()

    def signal_or_spec(self) -> Any:
        assert self.video_speech_results_ is not None
        return self.video_speech_results_

    @property
    def prefer_host_align(self) -> bool:
        """Host-score only when the embedded-subs path produced cue geometry
        (no audio pipeline ran); audio labels live on the device."""
        from ffsubsync_tpu_torch.subs.raster import RasterSpec

        return isinstance(self.video_speech_results_, RasterSpec)
