# -*- coding: utf-8 -*-
"""Plain webrtc-class detector over one chunk of windows, in float64 NumPy
with sequential scans (``np.cumsum``, ``np.minimum.accumulate``, a
first-order recursive filter for the EMA).

Per window: band energies -> EMA (alpha 0.35) -> noise floor (running
minimum of the log EMA, rising 0.3% a window) -> the weighted band SNR
against 6 dB, gated by spectral motion (normalized mel flux, its duty
cycle over +-60 windows), a sustained-music veto (syllabic modulation over
+-60 windows) and a transient-train veto, with an 8-window hangover and a
half-weight 26-window pre-hangover. State carried to the next chunk: the
EMA, the noise floor, the last spectrum, the last 60 motion indicators and
the last 85 dB levels.
"""
import numpy as np
from scipy.signal import lfilter

ALPHA = 0.35
GROWTH = 1.0030
BAND_WEIGHTS = np.array([0.6, 1.0, 1.0, 0.9, 0.7, 0.5])
SNR_DB = 6.0
HANGOVER, PRE_HANGOVER, PRE_WEIGHT = 8, 26, 0.5
FLUX_NOISE_C, FLUX_MOVE, FLUX_K, FLUX_FRAC = 0.38, 0.08, 60, 0.45
SYL_SHORT, SYL_LONG, SYL_MOD = 5, 25, 0.75
LOOKBACK = FLUX_K + SYL_LONG
FAST_SHORT, FAST_MAX = 1, 2.5
N_MELS = 40
DB_PER_LN = 10.0 / np.log(10.0)
FAR = 1 << 30


def fresh_state():
    return {"ema": np.full(6, np.inf), "noise": np.full(6, np.inf),
            "prev_p": np.full(N_MELS, np.inf), "prev_m": np.zeros((FLUX_K, 2)),
            "prev_m_len": 0, "prev_ldb": np.zeros(LOOKBACK), "prev_ldb_len": 0}


def _prefix_pairs(values, counts):
    return np.concatenate([np.zeros((1, 2)), np.cumsum(np.stack([values, counts], 1), 0)])


def _box(prefix, pos, k):
    lo = np.maximum(pos - k, 0)
    hi = np.minimum(pos + k, prefix.shape[0] - 2)
    s = prefix[hi + 1] - prefix[lo]
    return s[:, 0] / np.maximum(s[:, 1], 1.0)


def keep(x):
    return x


def detect(bands, logmel, state, store=keep):
    """(strength [T] in {0, 0.5, 1}, fuse [T] bool, new state) of one chunk.
    ``store`` rounds each intermediate array as it is kept (the control
    keeps them in bfloat16; the reference as they are)."""
    t_n = bands.shape[0]
    t = np.arange(t_n)
    e = store(np.maximum(bands, 1e-12))
    carry0 = np.where(np.isinf(state["ema"]), e[0], state["ema"])
    ema = store(lfilter([ALPHA], [1.0, -(1.0 - ALPHA)], e, axis=0,
                        zi=((1.0 - ALPHA) * carry0)[None, :])[0])
    ln_ema = store(np.log(ema))
    tt = t[:, None] * np.log(GROWTH)
    cummin = np.minimum.accumulate(ln_ema - tt, axis=0)
    with np.errstate(divide="ignore"):
        ln_noise_in = np.log(state["noise"])
    ln_noise = store(np.minimum(tt + cummin, ln_noise_in[None, :] + tt + np.log(GROWTH)))
    snr_db = store(DB_PER_LN * (ln_ema - ln_noise))
    score = store(snr_db @ BAND_WEIGHTS / BAND_WEIGHTS.sum())

    mel = store(np.exp(logmel))
    p = store(mel / mel.sum(axis=1, keepdims=True))
    prev = np.concatenate([state["prev_p"][None, :], p[:-1]])
    prev = np.where(np.isinf(prev), p, prev)
    flux = store(0.5 * np.abs(p - prev).sum(axis=1))
    noise_sum = store(np.exp(ln_noise).sum(axis=1))
    flux_c = store(np.maximum(flux - FLUX_NOISE_C * noise_sum / ema.sum(axis=1), 0.0))
    active = score > SNR_DB
    moving = flux_c > FLUX_MOVE
    ind_ext = np.concatenate([state["prev_m"],
                              np.stack([moving & active, active], 1).astype(np.float64)])
    s_pad = np.concatenate([np.zeros((1, 2)), np.cumsum(ind_ext, 0)])
    lo = np.maximum(t, FLUX_K - state["prev_m_len"])
    hi = np.minimum(t + 2 * FLUX_K, FLUX_K + t_n - 1)
    sums = s_pad[hi + 1] - s_pad[lo]
    frac = store(sums[:, 0] / np.maximum(sums[:, 1], 1.0))

    ldb = store(DB_PER_LN * np.log(np.maximum(e.sum(axis=1), noise_sum)))
    prev_valid = np.arange(LOOKBACK) >= LOOKBACK - state["prev_ldb_len"]
    ldb_ext = np.concatenate([np.where(prev_valid, state["prev_ldb"], 0.0), ldb])
    valid_ext = np.concatenate([prev_valid, np.ones(t_n, bool)]).astype(np.float64)
    ps_ldb = _prefix_pairs(ldb_ext, valid_ext)
    ext = np.arange(LOOKBACK + t_n)
    bp = store(_box(ps_ldb, ext, SYL_SHORT) - _box(ps_ldb, ext, SYL_LONG))
    sylmod = store(_box(_prefix_pairs(np.abs(bp) * valid_ext, valid_ext), t + LOOKBACK, FLUX_K))
    bpf = store(_box(ps_ldb, ext, FAST_SHORT) - _box(ps_ldb, ext, SYL_SHORT))
    fastmod = store(_box(_prefix_pairs(np.abs(bpf) * valid_ext, valid_ext), t + LOOKBACK,
                         FLUX_K))

    raw = (active & moving & (frac > FLUX_FRAC) & (sylmod > SYL_MOD) & (fastmod <= FAST_MAX))
    last = np.maximum.accumulate(np.where(raw, t, -FAR))
    nxt = np.minimum.accumulate(np.where(raw, t, FAR)[::-1])[::-1]
    fuse = t - last < HANGOVER
    strength = np.where(fuse, 1.0, np.where(nxt - t < PRE_HANGOVER, PRE_WEIGHT, 0.0))
    out = t_n - 1
    new = {"ema": ema[out], "noise": np.exp(ln_noise[out]), "prev_p": p[out],
           "prev_m": ind_ext[t_n: t_n + FLUX_K],
           "prev_m_len": min(state["prev_m_len"] + t_n, FLUX_K),
           "prev_ldb": ldb_ext[t_n: t_n + LOOKBACK],
           "prev_ldb_len": min(state["prev_ldb_len"] + t_n, LOOKBACK)}
    return strength, fuse, new
