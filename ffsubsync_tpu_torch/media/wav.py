# -*- coding: utf-8 -*-
"""Native WAV (RIFF PCM) streaming reader.

A TPU-deployment addition with no reference equivalent: the reference always
shells out to ffmpeg for audio decode. WAV/PCM needs no codec, so decoding it
in-process removes the subprocess round trip entirely (and keeps the audio
path usable on hosts without ffmpeg). Supports PCM16/PCM8/float32 WAVs, any
channel count (mixed down to mono), with linear resampling to the target rate.
"""
import logging
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class WavFormatError(ValueError):
    pass


def _parse_header(f) -> Tuple[int, int, int, int, int, int]:
    """Returns (audio_format, channels, sample_rate, bits, data_offset, data_size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    audio_format = channels = sample_rate = bits = None
    data_offset = data_size = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, size = header[:4], struct.unpack("<I", header[4:8])[0]
        if chunk_id == b"fmt ":
            fmt = f.read(size)
            audio_format, channels, sample_rate = struct.unpack("<HHI", fmt[:8])
            bits = struct.unpack("<H", fmt[14:16])[0]
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", fmt[24:26])[0]
        elif chunk_id == b"data":
            data_offset = f.tell()
            data_size = size
            break
        else:
            f.seek(size + (size & 1), 1)
    if None in (audio_format, channels, sample_rate, bits, data_offset):
        raise WavFormatError("missing fmt/data chunk")
    return audio_format, channels, sample_rate, bits, data_offset, data_size


def is_wav_file(fname: str) -> bool:
    try:
        with open(fname, "rb") as f:
            magic = f.read(12)
        return magic[:4] == b"RIFF" and magic[8:12] == b"WAVE"
    except OSError:
        return False


class WavReader:
    """Streams a WAV file as mono int16 chunks at a target sample rate."""

    def __init__(self, fname: str) -> None:
        self.fname = fname
        with open(fname, "rb") as f:
            (
                self.audio_format,
                self.channels,
                self.sample_rate,
                self.bits,
                self.data_offset,
                self.data_size,
            ) = _parse_header(f)
        if self.audio_format == 1 and self.bits == 16:
            self._dtype, self._scale = np.dtype("<i2"), 1.0
        elif self.audio_format == 1 and self.bits == 8:
            self._dtype, self._scale = np.dtype("u1"), 256.0  # offset-binary
        elif self.audio_format == 3 and self.bits == 32:
            self._dtype, self._scale = np.dtype("<f4"), 32767.0
        else:
            raise WavFormatError(
                "unsupported WAV format %d/%d-bit" % (self.audio_format, self.bits)
            )
        bytes_per_frame = self.channels * self._dtype.itemsize
        # clamp to the real payload: truncated downloads and streaming
        # writers (placeholder/0xFFFFFFFF data sizes) claim more than the
        # file holds, and the memmap path would otherwise refuse to map
        avail = max(0, os.path.getsize(fname) - self.data_offset)
        self.n_frames = min(self.data_size, avail) // bytes_per_frame

    @property
    def duration_seconds(self) -> float:
        return self.n_frames / float(self.sample_rate)

    def _to_mono_i16(self, raw: np.ndarray) -> np.ndarray:
        if self.channels == 1 and self._dtype == np.dtype("<i2"):
            return raw  # already mono s16le — zero-copy
        frames = raw.reshape(-1, self.channels)
        if self._dtype.kind == "u":  # 8-bit offset binary → centered
            mono = (frames.astype(np.float32).mean(axis=1) - 128.0) * self._scale
        elif self._dtype.kind == "f":
            mono = frames.astype(np.float32).mean(axis=1) * self._scale
        else:
            from ffsubsync_tpu_torch import native

            return native.mix_to_mono_i16(frames)
        return np.clip(mono, -32768, 32767).astype(np.int16)

    def iter_chunks(
        self,
        target_rate: int,
        chunk_seconds: float = 100.0,
        start_seconds: float = 0.0,
        max_duration_seconds: Optional[float] = None,
    ) -> Iterator[np.ndarray]:
        """Yield mono int16 chunks resampled to ``target_rate``."""
        src_rate = self.sample_rate
        start_frame = int(start_seconds * src_rate)
        end_frame = self.n_frames
        if max_duration_seconds is not None:
            end_frame = min(end_frame, start_frame + int(max_duration_seconds * src_rate))
        frames_per_chunk = int(chunk_seconds * src_rate)
        if (
            src_rate == target_rate
            and self.channels == 1
            and self._dtype == np.dtype("<i2")
        ):
            # the hot case (mono s16le at the target rate): map the data
            # section and yield slices — the host's one pass over the PCM
            # happens in the consumer (VAD staging), driven by page faults,
            # instead of an eager read-copy here
            data = np.memmap(
                self.fname,
                dtype="<i2",
                mode="r",
                offset=self.data_offset,
                shape=(self.n_frames,),
            )
            pos = start_frame
            while pos < end_frame:
                n = min(frames_per_chunk, end_frame - pos)
                yield data[pos : pos + n]
                pos += n
            return
        prev_tail: Optional[np.ndarray] = None  # one source sample of overlap
        with open(self.fname, "rb") as f:
            pos = start_frame
            while pos < end_frame:
                n = min(frames_per_chunk, end_frame - pos)
                f.seek(self.data_offset + pos * self.channels * self._dtype.itemsize)
                raw = np.frombuffer(
                    f.read(n * self.channels * self._dtype.itemsize), self._dtype
                )
                if raw.size == 0:
                    break
                mono = self._to_mono_i16(raw)
                if src_rate == target_rate:
                    yield mono
                else:
                    # linear resample with one-sample overlap for continuity
                    if prev_tail is not None:
                        mono_ext = np.concatenate([prev_tail, mono])
                        t0 = pos - 1
                    else:
                        mono_ext = mono
                        t0 = pos
                    prev_tail = mono[-1:]
                    src_t = (t0 + np.arange(len(mono_ext))) / src_rate
                    out_start = int(np.ceil(pos / src_rate * target_rate))
                    out_end = int(np.ceil((pos + n) / src_rate * target_rate))
                    dst_t = np.arange(out_start, out_end) / target_rate
                    resampled = np.interp(dst_t, src_t, mono_ext.astype(np.float64))
                    yield np.clip(resampled, -32768, 32767).astype(np.int16)
                pos += n
