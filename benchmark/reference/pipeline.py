# -*- coding: utf-8 -*-
"""The plain reference of one sync: the WAV read as data, the labels per
10 ms window chunk by chunk with the detectors' state carried, the search
and the synced cues.

It imports nothing of the program: every step is worked out again from
the files both sides read (the WAV, the SRT, the shipped weights).
"""
import struct

import numpy as np
import torch

from benchmark.reference import frontend, net, webrtc

PRODUCTS = {"float64": "float64", "control": "tf32"}


def bfloat16(x):
    """``x`` rounded to bfloat16 (nearest even), kept in float64."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16).to(
        torch.float64).numpy()


def read_wav(path):
    """(rate, int16 samples) of a mono 16-bit PCM WAV."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("%s is no WAV file" % path)
        rate = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                raise ValueError("%s has no data chunk" % path)
            kind, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            if kind == b"fmt ":
                fmt = f.read(size)
                audio_format, channels, rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
                if (audio_format, channels, bits) != (1, 1, 16):
                    raise ValueError("%s is not mono 16-bit PCM" % path)
            elif kind == b"data":
                offset = f.tell()
                break
            else:
                f.seek(size + (size & 1), 1)
    return rate, np.memmap(path, dtype="<i2", mode="r", offset=offset, shape=(size // 2,))


class Detector:
    """A ``--vad`` mode's labels over a stream of chunks, state carried."""

    def __init__(self, mode, rate, sample_rate, precision, device, weights_path=None):
        self.mode, self.rate, self.window = mode, rate, rate // sample_rate
        self.products = PRODUCTS[precision]
        self.device = device
        self.webrtc_state = webrtc.fresh_state()
        if mode != "webrtc":
            self.weights = net.load_weights(weights_path, self.products, device)
            dtype = torch.float64 if self.products == "float64" else torch.float32
            self.net_state = net.fresh_state(device, dtype)

    def __call__(self, pcm):
        raw = frontend.frames(pcm, self.window)
        logmel, bands, _total = frontend.frontend(raw, self.window, self.rate, self.products,
                                                  self.device)
        store = webrtc.keep
        if self.products != "float64":
            # the control keeps the frontend's outputs and the detector's
            # arrays in bfloat16 (the detector's math is float32)
            store = bfloat16
            logmel, bands = store(logmel), store(bands)
        strength, fuse, self.webrtc_state = webrtc.detect(bands, logmel, self.webrtc_state,
                                                          store)
        if self.mode == "webrtc":
            return strength
        p, self.net_state = net.probs(self.weights, logmel, self.net_state, self.products)
        if self.mode == "weighted":
            return 0.6 * p + 0.4 * fuse
        raise ValueError("unknown mode %r" % self.mode)


def labels(wav_path, mode, chunk_seconds, precision, device, weights_path=None,
           sample_rate=100):
    """Labels of the whole reference, float64 [windows]."""
    rate, pcm = read_wav(wav_path)
    det = Detector(mode, rate, sample_rate, precision, device, weights_path)
    chunk = int(chunk_seconds * sample_rate) * (rate // sample_rate)
    if chunk <= 0 or len(pcm) <= chunk:
        return det(pcm)
    return np.concatenate([det(pcm[i: i + chunk]) for i in range(0, len(pcm), chunk)])
