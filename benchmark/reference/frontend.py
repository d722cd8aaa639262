# -*- coding: utf-8 -*-
"""Plain frontend: the staged wire worked out again from the PCM, then per
10 ms window the log-mel features, the detector's six band powers and the
total power.

The wire is 8-bit mu-law (mu = 255, 127 levels a side), the window is
zero-padded at the end of the signal, the log-mel spectrum is taken from a
periodic Hann window and the band powers from no window, as ffsubsync's
detectors define them. ``precision="float64"`` is the reference;
``"tf32"`` is the control: the DFT and the mel and band sums as float32
products of operands rounded to TF32 (10 mantissa bits), the step a
faster frontend would take.
"""
import math

import numpy as np
import torch

from benchmark.harness.yardstick import band_selector, mel_filterbank

MU = 255.0
LOG_MEL_EPS = 1e-6


def mulaw_codes(pcm_i16):
    """int8-range mu-law codes of int16 PCM, in exact arithmetic."""
    x = np.asarray(pcm_i16, np.float64) / 32768.0
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / np.log1p(MU)
    return np.round(y * 127.0)


def frames(pcm_i16, window):
    """[T, window] mu-law decoded samples (int16 scale), float64, the last
    window zero-padded; T = ceil(len / window)."""
    codes = mulaw_codes(pcm_i16)
    t = max(1, -(-len(codes) // window))
    padded = np.zeros(t * window)
    padded[: len(codes)] = codes
    mag = np.abs(padded) / 127.0
    raw = np.sign(padded) * (32768.0 / MU) * (np.exp2(mag * 8.0) - 1.0)
    return raw.reshape(t, window)


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits, ties away from zero)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b):
    return tf32(a) @ tf32(b)


def dft_basis(window, dtype, device):
    """[window, 2F] cos | sin of the real DFT of F = window // 2 + 1 bins."""
    f = window // 2 + 1
    t = torch.arange(window, dtype=torch.float64)[:, None]
    ang = 2.0 * math.pi * ((t * torch.arange(f, dtype=torch.float64)[None, :]) % window) / window
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).to(device=device, dtype=dtype)


def frontend(raw, window, rate, precision, device):
    """(logmel [T, 40], bands [T, 6], total [T]) of decoded frames ``raw``
    (numpy [T, window]), as numpy float64."""
    f = window // 2 + 1
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(window) / window)
    mel = mel_filterbank(f, rate)
    sel = band_selector(f, rate, window)
    if precision == "float64":
        x = torch.from_numpy(raw).to(device) / 32768.0
        spec_m = torch.fft.rfft(x * torch.from_numpy(hann).to(device), dim=-1)
        p_mel = spec_m.real ** 2 + spec_m.imag ** 2
        spec_p = torch.fft.rfft(x, dim=-1)
        p_pl = spec_p.real ** 2 + spec_p.imag ** 2
        logmel = torch.log(p_mel @ torch.from_numpy(mel).to(device) + LOG_MEL_EPS)
        bands = p_pl @ torch.from_numpy(sel).to(device)
    elif precision == "tf32":
        f32 = torch.float32
        x = torch.from_numpy(raw).to(device=device, dtype=f32) / 32768.0
        basis = dft_basis(window, f32, device)
        hann_t = torch.from_numpy(hann).to(device=device, dtype=f32)

        def power(frames_):
            cs = tf32_matmul(frames_, basis)
            return cs[:, :f] ** 2 + cs[:, f:] ** 2

        p_mel = power(x * hann_t)
        p_pl = power(x)
        logmel = torch.log(tf32_matmul(p_mel, torch.from_numpy(mel).to(device, f32))
                           + LOG_MEL_EPS)
        bands = tf32_matmul(p_pl, torch.from_numpy(sel).to(device, f32))
    else:
        raise ValueError("unknown precision %r" % precision)
    total = np.mean(raw * raw, axis=1)
    return (logmel.to(torch.float64).cpu().numpy(), bands.to(torch.float64).cpu().numpy(),
            total)
