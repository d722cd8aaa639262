# -*- coding: utf-8 -*-
"""Voice-activity detection on the device, in PyTorch.

Counterpart of ``ffsubsync_tpu/ops/vad.py``. Every ``--vad`` mode of this
port runs one function per pipeline chunk, :func:`_vad_program`: the fused
frontend (the CUDA kernel on the card), then the webrtc-class spectral
detector (:func:`_webrtc_from_bands`) and/or the neural detector
(:class:`~ffsubsync_tpu_torch.models.neural_vad.NeuralVADNet`), then the
fusion the mode names. Detector state (EMA, noise floor, flux/modulation
history, neural context) is carried across chunks as device tensors, and
the labels stay on the device (:class:`LazySpeechSignal`) until the
aligner or a host consumer reads them.

The webrtc-class recurrences are scans along the window axis, as in the
reference (its two-level ``_blocked_scan``): the affine EMA, the running
minimum of the noise floor, the prefix sums of the flux and modulation
boxes and the hangover's running max and reverse running min. Each goes
through :mod:`~ffsubsync_tpu_torch.ops.scan`: on the card one call of the
hand-written kernel ``csrc/scan.cu`` (two levels of 4096-row tiles, the
reference's), on the CPU the plain ``torch.cumsum``/``cummin``/``cummax``
and a doubling scan for the EMA. The rest of the detector (the
elementwise math, the spectral flux, the box gathers) is plain PyTorch on
either device. The tuning constants are the reference's; the rationale
for each lives beside the originals.

``--vad auditok`` (:func:`make_auditok_detector`) is the exception to the
one-program rule, as in the reference: one frontend launch over the whole
signal, one pull of its window powers, and the auditok-class tokenizer on
the host (a sequential state machine the device is wrong for).
"""
import functools
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ffsubsync_tpu_torch.device import host_to_device
from ffsubsync_tpu_torch.models.neural_vad import (
    CONTEXT,
    N_MELS,
    NeuralVADNet,
    load_net,
)
from ffsubsync_tpu_torch.ops import scan
from ffsubsync_tpu_torch.ops.features import (
    analysis_rate,
    compute_frontend,
    stage_to_device,
)
from ffsubsync_tpu_torch.ops.frontend import fused_frontend
from ffsubsync_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

_FUSION_STRATEGIES: Tuple[str, ...] = ("weighted", "intersection", "union")

# auditok-parity tokenizer constants (ffsubsync_tpu/ops/vad.py)
ENERGY_THRESHOLD_DB = 50.0
MIN_TOKEN_FACTOR = 0.2  # × sample_rate windows
MAX_TOKEN_FACTOR = 5.0
MAX_SILENCE_FACTOR = 0.25

# webrtc-class detector constants (ffsubsync_tpu/ops/vad.py constants block)
_ENERGY_EMA_ALPHA = 0.35
_NOISE_FLOOR_GROWTH = 1.0030
_BAND_WEIGHTS = np.array([0.6, 1.0, 1.0, 0.9, 0.7, 0.5], dtype=np.float32)
_SNR_THRESHOLD_DB = 6.0
_HANGOVER_WINDOWS = 8
_PRE_HANGOVER_WINDOWS = 26
_PRE_HANGOVER_WEIGHT = 0.5
_N_BANDS = len(_BAND_WEIGHTS)
_FLUX_NOISE_C = 0.38
_FLUX_MOVE_THRESHOLD = 0.08
_FLUX_BOX_K = 60
_FLUX_FRAC_THRESHOLD = 0.45
_SYL_SHORT_K = 5
_SYL_LONG_K = 25
_SYL_MOD_THRESHOLD = 0.75
_SYL_LOOKBACK = _FLUX_BOX_K + _SYL_LONG_K
_FAST_SHORT_K = 1
_FAST_MOD_MAX = 2.5

_DB_PER_LN = 10.0 / np.log(10.0)


def _pcm_bytes_to_i16(chunk) -> np.ndarray:
    if isinstance(chunk, np.ndarray):
        if chunk.dtype == np.uint8:  # uint8 views of s16le
            return chunk.view(np.int16)
        if chunk.dtype == np.int16:
            return chunk
        return chunk.astype(np.int16)
    return np.frombuffer(chunk, np.int16)


# the EMA's plain doubling scan, under this module's earlier name
_affine_scan = scan.affine_scan_plain


@functools.lru_cache(maxsize=16)
def _band_weights(device: torch.device) -> torch.Tensor:
    """The band weights on ``device``, made once per device: a copy from
    the host inside a chunk's program would stall the host there."""
    return host_to_device(_BAND_WEIGHTS, device)


def _select_labels(mode, webrtc_labels, silero_labels):
    """--vad mode -> label stream (parity: speech_transformers.py:282-294)."""
    if mode == "webrtc":
        return webrtc_labels
    if mode == "silero":
        return silero_labels
    if mode == "intersection":
        return torch.minimum(webrtc_labels, silero_labels)
    if mode == "union":
        return torch.maximum(webrtc_labels, silero_labels)
    return 0.6 * silero_labels + 0.4 * webrtc_labels


def _spectral_flux(logmel, prev_p_in):
    """Per-window normalized-mel-spectrum flux ([T], plus p [T, M]);
    ``+inf`` in ``prev_p_in`` marks a fresh stream (flux[0] == 0)."""
    mel = torch.exp(logmel)
    p = mel / torch.sum(mel, dim=1, keepdim=True)
    prev = torch.cat([prev_p_in[None, :], p[:-1]], dim=0)
    prev = torch.where(torch.isinf(prev), p, prev)
    flux = 0.5 * torch.sum(torch.abs(p - prev), dim=1)
    return flux, p


def _box_mean_prefix(prefix, pos, k0):
    """Mean of a masked series over the ±k0 box around ``pos``, from its
    ``[N+1, 2]`` (value, count) prefix sums; edges clamp to the series."""
    b_lo = torch.clamp(pos - k0, min=0)
    b_hi = torch.clamp(pos + k0, max=prefix.shape[0] - 2)
    s = prefix[b_hi + 1] - prefix[b_lo]
    return s[:, 0] / torch.clamp(s[:, 1], min=1.0)


def _prefix_pairs(values, counts):
    """[N+1, 2] prefix sums of (values, counts) with a leading zero row."""
    pairs = torch.stack([values, counts], dim=1)
    zero = torch.zeros((1, 2), dtype=pairs.dtype, device=pairs.device)
    return torch.cat([zero, scan.scan_cols(pairs, "add")], dim=0)


def _webrtc_from_bands(bands, logmel, n_valid, ema_in, noise_in, prev_p_in,
                       prev_m_in, prev_m_len, prev_ldb_in, prev_ldb_len):
    """Band energies -> EMA -> min-statistics noise floor -> weighted SNR
    vote, gated by spectral-motion duty cycle, the sustained-music and
    transient-train vetoes, with hangover (``ffsubsync_tpu/ops/vad.py::
    _webrtc_from_bands``, same math and the same carried state).

    ``bands``/``logmel`` may hold rows past ``n_valid`` (padding): padded
    rows are scan identities and the carried-out state is read at
    ``n_valid - 1``. ``n_valid``, ``prev_m_len`` and ``prev_ldb_len`` are
    host ints. Returns (speech_strength [T] float, speech_fuse [T] bool,
    ema [B], noise [B], prev_p [M], prev_m [K, 2], prev_m_len,
    prev_ldb [L], prev_ldb_len).
    """
    dev = bands.device
    f32 = torch.float32
    t_pad = bands.shape[0]
    t_idx = torch.arange(t_pad, device=dev)
    valid = (t_idx < n_valid)[:, None]
    e = torch.clamp(bands, min=1e-12)  # [T, B]
    carry0 = torch.where(torch.isinf(ema_in), e[0], ema_in)
    coef_a = torch.where(
        valid, torch.full_like(e, 1.0 - _ENERGY_EMA_ALPHA), torch.ones_like(e)
    )
    coef_b = torch.where(valid, _ENERGY_EMA_ALPHA * e, torch.zeros_like(e))
    big_a, big_b = scan.affine_scan(coef_a, coef_b)
    ema_seq = big_a * carry0[None, :] + big_b  # [T, B]
    ln_ema = torch.log(ema_seq)
    lng = float(np.float32(np.log(_NOISE_FLOOR_GROWTH)))
    tt = t_idx.to(f32)[:, None] * lng
    inf = torch.full_like(ln_ema, float("inf"))
    cummin = scan.scan_cols(torch.where(valid, ln_ema - tt, inf), "min")
    ln_noise = torch.minimum(tt + cummin, torch.log(noise_in)[None, :] + tt + lng)
    snr_db = _DB_PER_LN * (ln_ema - ln_noise)
    score = (snr_db @ _band_weights(dev)) / float(_BAND_WEIGHTS.sum())

    flux, p = _spectral_flux(logmel, prev_p_in)
    noise_sum = torch.sum(torch.exp(ln_noise), dim=1)
    noise_frac = noise_sum / torch.sum(ema_seq, dim=1)
    flux_c = torch.clamp(flux - _FLUX_NOISE_C * noise_frac, min=0.0)
    k = _FLUX_BOX_K
    active = (score > _SNR_THRESHOLD_DB) & valid[:, 0]
    moving = (flux_c > _FLUX_MOVE_THRESHOLD) & valid[:, 0]
    ind = torch.stack([(moving & active).to(f32), active.to(f32)], dim=1)
    ind_ext = torch.cat([prev_m_in, ind], dim=0)  # [K + T, 2]
    zero = torch.zeros((1, 2), dtype=f32, device=dev)
    s_pad = torch.cat([zero, scan.scan_cols(ind_ext, "add")], dim=0)
    # box edges in ind_ext coordinates (window t sits at t + K)
    lo = torch.clamp(t_idx, min=k - prev_m_len)
    hi = torch.clamp(t_idx + 2 * k, max=k + n_valid - 1)
    sums = s_pad[hi + 1] - s_pad[lo]
    frac = sums[:, 0] / torch.clamp(sums[:, 1], min=1.0)

    # sustained-music veto: syllabic-band energy modulation
    big_l = _SYL_LOOKBACK
    v1 = valid[:, 0]
    ldb = _DB_PER_LN * torch.log(torch.maximum(torch.sum(e, dim=1), noise_sum))
    prev_valid = torch.arange(big_l, device=dev) >= big_l - prev_ldb_len
    ldb_ext = torch.cat(
        [
            torch.where(prev_valid, prev_ldb_in, 0.0),
            torch.where(v1, ldb, 0.0),
        ]
    )
    valid_ext = torch.cat([prev_valid, v1]).to(f32)
    ps_ldb = _prefix_pairs(ldb_ext, valid_ext)
    ext_idx = torch.arange(big_l + t_pad, device=dev)
    bp = _box_mean_prefix(ps_ldb, ext_idx, _SYL_SHORT_K) - _box_mean_prefix(
        ps_ldb, ext_idx, _SYL_LONG_K
    )
    ps_bp = _prefix_pairs(torch.abs(bp) * valid_ext, valid_ext)
    sylmod = _box_mean_prefix(ps_bp, t_idx + big_l, _FLUX_BOX_K)

    # transient-train veto: super-syllabic |AM| over the same dB history
    bpf = _box_mean_prefix(ps_ldb, ext_idx, _FAST_SHORT_K) - _box_mean_prefix(
        ps_ldb, ext_idx, _SYL_SHORT_K
    )
    ps_bpf = _prefix_pairs(torch.abs(bpf) * valid_ext, valid_ext)
    fastmod = _box_mean_prefix(ps_bpf, t_idx + big_l, _FLUX_BOX_K)

    raw = (
        active
        & moving
        & (frac > _FLUX_FRAC_THRESHOLD)
        & (sylmod > _SYL_MOD_THRESHOLD)
        & (fastmod <= _FAST_MOD_MAX)
    )
    # the reference's int32 sentinels: no raw vote before / after
    far = 1 << 30
    t32 = t_idx.to(torch.int32)
    last = scan.scan_cols(torch.where(raw, t32, -far), "max")
    nxt = scan.scan_cols(torch.where(raw, t32, far), "min", reverse=True)
    # the standalone stream adds the half-weight pre-hangover; the fusion
    # stream keeps the trailing-only hangover (reference docstring)
    speech_fuse = t_idx - last < _HANGOVER_WINDOWS
    pre = nxt - t_idx < _PRE_HANGOVER_WINDOWS
    speech_strength = torch.where(
        speech_fuse,
        1.0,
        torch.where(pre, _PRE_HANGOVER_WEIGHT, 0.0),
    ).to(f32)
    out_t = max(n_valid - 1, 0)
    return (
        speech_strength,
        speech_fuse,
        ema_seq[out_t],
        torch.exp(ln_noise[out_t]),
        p[out_t],
        ind_ext[n_valid : n_valid + k],
        min(prev_m_len + n_valid, k),
        ldb_ext[n_valid : n_valid + big_l],
        min(prev_ldb_len + n_valid, big_l),
    )


def initial_state(device: torch.device) -> Dict[str, object]:
    """Carried detector state of a fresh stream (``+inf`` = uninitialized)."""
    inf = float("inf")
    return {
        "ema": torch.full((_N_BANDS,), inf, device=device),
        "noise": torch.full((_N_BANDS,), inf, device=device),
        "prev_p": torch.full((N_MELS,), inf, device=device),
        "prev_m": torch.zeros((_FLUX_BOX_K, 2), device=device),
        "prev_m_len": 0,
        "prev_ldb": torch.zeros((_SYL_LOOKBACK,), device=device),
        "prev_ldb_len": 0,
        "carry": torch.zeros((CONTEXT, N_MELS), device=device),
        "carry_len": 0,
    }


@tracing.spanned("vad_program")
def _vad_program(framed, window, frame_rate, n_valid, state,
                 net: Optional[NeuralVADNet], non_speech_label, mode):
    """One VAD chunk: frontend -> detector backend(s) -> labels, plus the
    carried state (``ffsubsync_tpu/ops/vad.py::_vad_program``).

    ``mode`` is "webrtc", "silero" or a fusion strategy; the backend a mode
    does not read is not computed. The neural context is a fixed
    [CONTEXT, M] buffer whose last ``carry_len`` rows are valid; rows
    outside the valid run are zeroed after normalization, the SAME padding
    the convs would see at a true signal boundary. Returns ``(labels [T]
    float32, new_state)``.
    """
    logmel, bands, _total = fused_frontend(framed, window, frame_rate)
    new = dict(state)
    webrtc_labels = silero_labels = None
    if mode != "silero":
        (
            speech, speech_fuse, new["ema"], new["noise"], new["prev_p"],
            new["prev_m"], new["prev_m_len"], new["prev_ldb"],
            new["prev_ldb_len"],
        ) = _webrtc_from_bands(
            bands, logmel, n_valid, state["ema"], state["noise"],
            state["prev_p"], state["prev_m"], state["prev_m_len"],
            state["prev_ldb"], state["prev_ldb_len"],
        )
        if mode == "webrtc":
            webrtc_labels = non_speech_label + (1.0 - non_speech_label) * speech
        else:
            webrtc_labels = torch.where(speech_fuse, 1.0, non_speech_label).to(
                torch.float32
            )
    if mode != "webrtc":
        ctx = CONTEXT
        carry_len = state["carry_len"]
        feats = torch.cat([state["carry"], logmel], dim=0)  # [ctx+T, M]
        rows = torch.arange(feats.shape[0], device=feats.device)
        valid_rows = (rows >= ctx - carry_len) & (rows < ctx + n_valid)
        mask = valid_rows[:, None]
        denom = max(carry_len + n_valid, 1)
        mean = torch.sum(feats * mask, dim=0, keepdim=True) / denom
        var = torch.sum(((feats - mean) * mask) ** 2, dim=0, keepdim=True) / denom
        x = (feats - mean) / (torch.sqrt(var) + 1e-3)
        x = torch.where(mask, x, 0.0)
        with torch.no_grad(), tracing.span("net"):
            probs = net(x, valid_rows.to(x.dtype))[ctx:]
        tracing.count("net.calls")
        tracing.count("net.windows", int(x.shape[0]))  # the carried context's rows too
        silero_labels = 1.0 - (1.0 - probs) * (1.0 - non_speech_label)
        new["carry"] = feats[n_valid : n_valid + ctx]
        new["carry_len"] = min(carry_len + n_valid, ctx)
    return _select_labels(mode, webrtc_labels, silero_labels), new


def _compact_chunks(arrays, n_valids, n: int) -> torch.Tensor:
    """The valid prefixes of label chunks joined, zero-padded to ``[n]``."""
    joined = torch.cat([a[:nv].to(torch.float32) for a, nv in zip(arrays, n_valids)])
    return torch.nn.functional.pad(joined, (0, n - joined.shape[0]))


class LazySpeechSignal:
    """VAD labels that stay on the device until host values are demanded.

    Parts are ``(labels, n_valid)`` pairs. :meth:`padded_values` joins them
    on the device into a target-length buffer (what the aligner reads),
    :meth:`materialize` is the one host pull (cached), and ``__array__``
    makes the object a drop-in for numpy consumers.
    """

    def __init__(self, parts) -> None:
        self._parts = []
        for p in parts:
            arr, nv = p if isinstance(p, tuple) else (p, int(p.shape[0]))
            nv = min(int(nv), int(arr.shape[0]))
            if nv > 0:
                self._parts.append((arr, nv))
        self._np: Optional[np.ndarray] = None
        self._dev_cache: dict = {}

    @property
    def device(self) -> Optional[torch.device]:
        return self._parts[0][0].device if self._parts else None

    def __len__(self) -> int:
        return sum(nv for _, nv in self._parts)

    def padded_values(self, n: int) -> torch.Tensor:
        """The signal as a device float32 [n] buffer, zeros beyond it."""
        if n < len(self):
            raise ValueError("target buffer %d shorter than the signal %d" % (n, len(self)))
        if n not in self._dev_cache:
            if self._parts:
                self._dev_cache[n] = _compact_chunks(
                    [a for a, _ in self._parts], [nv for _, nv in self._parts], n
                )
            else:
                self._dev_cache[n] = torch.zeros((n,), dtype=torch.float32)
        return self._dev_cache[n]

    @classmethod
    def from_host(cls, labels: np.ndarray, device: torch.device) -> "LazySpeechSignal":
        """Host-computed labels (the tokenizer's) put on ``device`` for the
        aligner; their exact float64 values stay cached for host readers."""
        sig = cls([torch.from_numpy(np.asarray(labels, np.float32)).to(device)])
        sig._np = np.asarray(labels, np.float64)
        return sig

    def materialize(self) -> np.ndarray:
        if self._np is None:
            self._np = (
                self.padded_values(len(self)).cpu().numpy().astype(np.float64)
            )
        return self._np

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def sum(self) -> float:
        """Device-side reduce; pulls one scalar."""
        if self._np is not None:
            return float(np.sum(self._np))
        return float(torch.sum(self.padded_values(len(self))))


def _gather_parts(handles) -> LazySpeechSignal:
    """Collect dispatched handles without a host pull."""
    flat = []
    for h in handles:
        flat.extend(h) if isinstance(h, list) else flat.append(h)
    return LazySpeechSignal(flat)


def _pipeline_chunk_samples(frame_rate: int, sample_rate: int) -> int:
    """Input samples per pipelined dispatch: ``FFS_TPU_PIPELINE_SECONDS``
    (default 2700 s = 45 min, the reference's; 0 disables chunking), a
    whole number of analysis windows and decimation strides."""
    seconds = float(os.environ.get("FFS_TPU_PIPELINE_SECONDS", "2700"))
    if seconds <= 0:
        return 0
    return int(seconds * sample_rate) * (frame_rate // sample_rate)


def _make_onelaunch_detector(
    mode: str, sample_rate: int, frame_rate: int, non_speech_label: float,
    device: torch.device,
) -> Callable:
    """Stateful chunk detector built on :func:`_vad_program`.

    Calling it with PCM returns host labels; ``dispatch_async(pcm)`` returns
    a list of lazy ``(labels, n_valid)`` handles (no host pull) and
    ``gather(handles)`` joins them into a :class:`LazySpeechSignal`. Both
    entry points split large buffers at the same pipeline-chunk boundaries,
    and the detector state flows chunk to chunk as device tensors.
    """
    state = {"s": initial_state(device)}
    net = None
    if mode != "webrtc":
        net = load_net(analysis_rate(frame_rate, sample_rate), device)

    def _dispatch(pcm):
        framed, rate, window, n_windows = stage_to_device(
            pcm, frame_rate, sample_rate, device
        )
        labels, state["s"] = _vad_program(
            framed, window, rate, n_windows,
            state["s"], net, non_speech_label, mode,
        )
        return labels, n_windows

    def _dispatch_async(pcm) -> list:
        pcm = _pcm_bytes_to_i16(pcm)
        if len(pcm) == 0:
            return []
        chunk = _pipeline_chunk_samples(frame_rate, sample_rate)
        if chunk <= 0 or len(pcm) <= chunk:
            return [_dispatch(pcm)]
        return [_dispatch(pcm[pos : pos + chunk]) for pos in range(0, len(pcm), chunk)]

    def _detect(pcm) -> np.ndarray:
        handles = _dispatch_async(pcm)
        return LazySpeechSignal(handles).materialize() if handles else np.zeros(0)

    _detect.dispatch_async = _dispatch_async
    _detect.gather = _gather_parts
    return _detect


def tokenize_validity(
    valid: np.ndarray, min_length: int, max_length: int, max_continuous_silence: int
) -> List[Tuple[int, int]]:
    """auditok-class stream tokenization of a boolean validity string:
    the native C++ state machine where ``libffs_native`` is built, else
    :func:`_tokenize_validity_py` (``ffsubsync_tpu/ops/vad.py::
    tokenize_validity``)."""
    from ffsubsync_tpu_torch import native

    if native.AVAILABLE:
        return native.tokenize(valid, min_length, max_length, max_continuous_silence)
    return _tokenize_validity_py(valid, min_length, max_length, max_continuous_silence)


def _tokenize_validity_py(
    valid: np.ndarray, min_length: int, max_length: int, max_continuous_silence: int
) -> List[Tuple[int, int]]:
    """The behavioral definition of :func:`tokenize_validity` (a copy of
    ``ffsubsync_tpu/ops/vad.py::_tokenize_validity_py``).

    Tokens begin at a valid frame, tolerate up to ``max_continuous_silence``
    consecutive invalid frames (which stay part of the token), end when
    silence exceeds that, are split at ``max_length``, and are dropped when
    shorter than ``min_length``.
    """
    tokens: List[Tuple[int, int]] = []
    start: Optional[int] = None
    silence_run = 0
    length = 0
    for i, v in enumerate(np.asarray(valid, dtype=bool)):
        if start is None:
            if v:
                start = i
                length = 1
                silence_run = 0
        else:
            if v:
                silence_run = 0
            else:
                silence_run += 1
            length += 1
            if silence_run > max_continuous_silence:
                end = i - silence_run
                if end - start + 1 >= min_length:
                    tokens.append((start, end + silence_run))  # keep trailing silence
                start = None
                length = 0
                silence_run = 0
                continue
            if length >= max_length:
                tokens.append((start, i))
                start = None
                length = 0
                silence_run = 0
    if start is not None:
        end = len(valid) - 1 - silence_run
        if end - start + 1 >= min_length:
            tokens.append((start, min(end + silence_run, len(valid) - 1)))
    return tokens


def make_auditok_detector(sample_rate, frame_rate, non_speech_label, device):
    """Energy tokenizer (``ffsubsync_tpu/ops/vad.py::make_auditok_detector``):
    one frontend launch over the signal on ``device``, one pull of the
    window powers, ``10·log10`` against the 50 dB line and the host
    tokenizer. Labels are 1.0 inside each token and, through the
    reference's cumsum shaping, 0 before the first token and
    ``non_speech_label`` after each one.

    ``dispatch_async`` only buffers PCM and ``gather`` tokenizes the WHOLE
    joined signal in one pass, so tokens never depend on pipeline chunking
    (a token straddling a chunk edge would split, and fragments under the
    minimum length would vanish). ``buffers_pcm`` tells the media layer that
    the handles retain the signal, so it must not pipeline when the
    duration, and with it the memory bound, is unknown.
    """
    min_length = int(MIN_TOKEN_FACTOR * sample_rate)
    max_length = int(MAX_TOKEN_FACTOR * sample_rate)
    max_silence = int(MAX_SILENCE_FACTOR * sample_rate)

    def _detect(chunk) -> np.ndarray:
        pcm = _pcm_bytes_to_i16(chunk)
        if len(pcm) == 0:
            return np.zeros(0)
        _logmel, _bands, total, n_windows = compute_frontend(
            pcm, frame_rate, sample_rate, device
        )
        energies = 10.0 * np.log10(np.maximum(total[:n_windows].cpu().numpy(), 1e-10))
        valid = energies >= ENERGY_THRESHOLD_DB
        media_bstring = np.zeros(n_windows + 1)
        for tok_start, tok_end in tokenize_validity(valid, min_length, max_length, max_silence):
            media_bstring[tok_start] = 1.0
            media_bstring[tok_end + 1] = non_speech_label - 1.0
        return np.clip(np.cumsum(media_bstring)[:-1], 0.0, 1.0)

    def _gather(handles) -> LazySpeechSignal:
        pcm_parts = []
        for h in handles:
            for tag, part in h if isinstance(h, list) else [h]:
                if tag != "auditok_pcm":
                    raise ValueError("not an auditok handle: %r" % (tag,))
                pcm_parts.append(part)
        if not pcm_parts:
            return LazySpeechSignal([])
        joined = pcm_parts[0] if len(pcm_parts) == 1 else np.concatenate(pcm_parts)
        return LazySpeechSignal.from_host(_detect(joined), device)

    _detect.dispatch_async = lambda chunk: [("auditok_pcm", _pcm_bytes_to_i16(chunk))]
    _detect.gather = _gather
    _detect.buffers_pcm = True
    return _detect


def make_webrtc_detector(sample_rate, frame_rate, non_speech_label, device):
    """WebRTC-class detector: flux-gated sub-band SNR on the device."""
    return _make_onelaunch_detector(
        "webrtc", sample_rate, frame_rate, non_speech_label, device
    )


def make_silero_detector(sample_rate, frame_rate, non_speech_label, device):
    """Neural VAD detector (in-tree silero-class model)."""
    return _make_onelaunch_detector(
        "silero", sample_rate, frame_rate, non_speech_label, device
    )


def make_fused_detector(sample_rate, frame_rate, non_speech_label, device,
                        fusion_strategy: str = "weighted"):
    """Webrtc-class and neural detectors fused per ``fusion_strategy``."""
    if fusion_strategy not in _FUSION_STRATEGIES:
        raise ValueError(
            "unknown fused VAD strategy %r; choose one of %s"
            % (fusion_strategy, ", ".join(_FUSION_STRATEGIES))
        )
    return _make_onelaunch_detector(
        fusion_strategy, sample_rate, frame_rate, non_speech_label, device
    )


def make_detector(vad: str, sample_rate: int, frame_rate: int,
                  non_speech_label: float, device: torch.device) -> Callable:
    """Dispatch a ``--vad`` name (possibly ``subs_then_``-prefixed) to a
    detector, in the reference's selection order."""
    if "fused" in vad:
        fusion_strategy = vad.split(":", 1)[1] if ":" in vad else "weighted"
        return make_fused_detector(
            sample_rate, frame_rate, non_speech_label, device, fusion_strategy
        )
    if "webrtc" in vad:
        return make_webrtc_detector(sample_rate, frame_rate, non_speech_label, device)
    if "auditok" in vad:
        return make_auditok_detector(sample_rate, frame_rate, non_speech_label, device)
    if "silero" in vad:
        return make_silero_detector(sample_rate, frame_rate, non_speech_label, device)
    raise ValueError("unknown vad: %s" % vad)
