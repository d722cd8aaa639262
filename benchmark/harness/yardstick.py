# -*- coding: utf-8 -*-
"""The yardstick: peaks of the card and the work each layer needs, counted
from the problem's shapes alone.

Nothing here reads the program: the mel filterbank and the band ranges are
worked out again from the analysis rate and the window, the scan bytes from
the window count, the net's operations from its published widths. So the
count does not move when the program changes how it does the work.
"""
import math

import numpy as np

# one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # bytes/s of HBM3

N_MELS = 40
N_BANDS = 6
BAND_EDGES_HZ = (80.0, 250.0, 500.0, 1000.0, 2000.0, 3000.0, 4000.0)
MEL_FMIN, MEL_FMAX = 60.0, 8000.0

# the neural VAD's published widths (log-mel 40 + 3 engineered channels,
# hidden 96, seven residual convs of kernel 5, one output) and its context
NET_IN, NET_HIDDEN, NET_KERNEL, NET_CONVS, NET_CONTEXT = 43, 96, 5, 7, 320

# the webrtc-class detector's scans per program: their lookbacks
FLUX_BOX_K = 60
SYL_LOOKBACK = 85


def mel_filterbank(n_freqs, frame_rate, n_mels=N_MELS, fmin=MEL_FMIN, fmax=MEL_FMAX):
    """[n_freqs, n_mels] triangular filterbank on the HTK mel scale."""
    def hz_to_mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    fmax = min(fmax, frame_rate / 2.0)
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = np.array([mel_to_hz(m) for m in mels])
    freqs = np.linspace(0.0, frame_rate / 2.0, n_freqs)
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        rising = (freqs - lo) / max(mid - lo, 1e-6)
        falling = (hi - freqs) / max(hi - mid, 1e-6)
        fb[:, m] = np.clip(np.minimum(rising, falling), 0.0, 1.0)
    return fb


def band_selector(n_freqs, frame_rate, window):
    """[n_freqs, 6] 0/1 map of rFFT bins to the detector's sub-bands."""
    freqs = np.fft.rfftfreq(window, d=1.0 / frame_rate)[:n_freqs]
    sel = np.zeros((n_freqs, N_BANDS))
    for b in range(N_BANDS):
        sel[(freqs >= BAND_EDGES_HZ[b]) & (freqs < BAND_EDGES_HZ[b + 1]), b] = 1.0
    return sel


def frontend_work(n_windows, window, frame_rate, row_bytes):
    """(float32 operations, bytes) the frontend needs for ``n_windows``
    windows: one real DFT of ``window // 2 + 1`` bins (a multiply-add by cos
    and by sin per sample and bin), the Hann spectrum from the plain one's
    neighbours, both powers, the band sums, a multiply-add per nonzero mel
    weight, the logs and the total power; the wire read once and 47 floats
    written per window."""
    f = window // 2 + 1
    mel_nonzero = int(np.count_nonzero(mel_filterbank(f, frame_rate)))
    band_bins = int(band_selector(f, frame_rate, window).sum())
    per_window = (4 * window * f + 8 * f + 6 * f + band_bins + 2 * mel_nonzero
                  + 2 * N_MELS + 2 * window + 1)
    return n_windows * per_window, n_windows * (row_bytes + (N_MELS + N_BANDS + 1) * 4)


def frontend_bound_s(n_windows, window, frame_rate, row_bytes):
    """The least seconds the card could take for the frontend's work: the
    larger of its operations at the float32 peak and its bytes at the
    memory peak."""
    ops, nbytes = frontend_work(n_windows, window, frame_rate, row_bytes)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def scan_bytes(n_windows):
    """Bytes the detector's eight scans of one ``n_windows`` program must
    move, each input read once and each output written once: the affine EMA
    pair over [T, 6] float32 (two inputs, two outputs), the noise floor's
    running minimum over [T, 6], the flux box's sums over [T + 60, 2], the
    three modulation sums over [T + 85, 2] and the hangover's running max
    and reverse running min over [T] int32."""
    t = n_windows
    return (4 * t * 6 * 4 + 2 * t * 6 * 4 + 2 * (t + FLUX_BOX_K) * 2 * 4
            + 3 * 2 * (t + SYL_LOOKBACK) * 2 * 4 + 2 * 2 * t * 4)


def scan_ops(n_windows):
    """Operations of the same eight scans: three per element of the affine
    pair, one per element of the others."""
    t = n_windows
    return (3 * t * 6 + t * 6 + (t + FLUX_BOX_K) * 2 + 3 * (t + SYL_LOOKBACK) * 2 + 2 * t)


def scan_bound_s(n_windows):
    return max(scan_bytes(n_windows) / PEAK_BYTES, scan_ops(n_windows) / PEAK_F32)


def net_flops(n_windows):
    """Operations of the net over one program's rows (its carried context
    and the chunk's windows): dense 43 -> 96, seven convs of 96 x 96 x 5,
    dense 96 -> 1, two per multiply-add."""
    per_row = 2 * (NET_IN * NET_HIDDEN + NET_CONVS * NET_HIDDEN * NET_HIDDEN * NET_KERNEL
                   + NET_HIDDEN)
    return (n_windows + NET_CONTEXT) * per_row


def search_flops(n, n_refs, n_candidates):
    """Operations of one FFT search at length ``n``: per reference one real
    FFT of it, per candidate one real FFT, the conjugate product and one
    inverse real FFT (2.5 n log2 n each), and the exact rescore (a
    multiply-add per sample)."""
    fft = 2.5 * n * math.log2(n)
    per_ref = fft + n_candidates * (2 * fft + 6 * (n // 2 + 1) + 2 * n)
    return n_refs * per_ref
