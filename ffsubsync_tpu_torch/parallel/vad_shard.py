# -*- coding: utf-8 -*-
"""Sequence-parallel VAD: one signal's window axis split over a device mesh.

Counterpart of ``ffsubsync_tpu/parallel/vad_shard.py``. The JAX package
runs the sharded program from one process (``shard_map`` under ``jit``);
so does this port. One controller holds the mesh (a sequence of
``torch.device``s, :func:`~ffsubsync_tpu_torch.device.local_mesh`), runs
each stage of the shard body once per shard on that shard's device, and
does the collectives as explicit tensor moves between stages:

- **frontend and per-window math** are shard-local: one launch of the
  frontend kernel per shard, on its device;
- **the spectral recurrences** (EMA, min-statistics floor, hangover) are
  scans: each shard scans locally, and the few-float summaries of its
  predecessors (or successors) are gathered to its device and folded in a
  D-step loop (:func:`_exclusive_prefix`, :func:`_exclusive_suffix`);
- **the box means and the neural VAD's dilated convs** need context rows
  from the neighbours: halo copies (:func:`_left_halos`,
  :func:`_right_halos`); the edge shards take zeros, the SAME padding the
  monolithic program sees at the signal's ends. The normalization sums are
  global (:func:`_all_sum`).

No host sync sits inside the program (no ``.item()``, no boolean-mask
indexing, no copy to the host), so on distinct GPUs the shards' launches
overlap. Every mask, box edge and hangover index uses the global window
index. The target is one monolithic ``ops/vad._vad_program`` call over
the whole signal (fresh state, one chunk), up to the reduction order.
"""
import functools
import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ffsubsync_tpu_torch.device import local_mesh
from ffsubsync_tpu_torch.models.neural_vad import CONTEXT, load_net
from ffsubsync_tpu_torch.ops import vad as V
from ffsubsync_tpu_torch.ops.features import analysis_rate, prepare_staged_input
from ffsubsync_tpu_torch.ops.frontend import fused_frontend, wire_silence_rows
from ffsubsync_tpu_torch.ops.vad import LazySpeechSignal

logger = logging.getLogger(__name__)

_FAR = 1 << 30  # "no raw vote" sentinel of the hangover scans


def _to(x, device: torch.device):
    """A tensor, or a tuple of them, on ``device``."""
    if isinstance(x, tuple):
        return tuple(t.to(device) for t in x)
    return x.to(device)


def _device(x) -> torch.device:
    return (x[0] if isinstance(x, tuple) else x).device


def _exclusive_prefix(summaries, combine, identity):
    """Each shard's combine of all earlier shards' scan summaries, on its
    own device; ``identity(own)`` for shard 0. ``summaries`` are the shards'
    inclusive local totals (a tensor or a tuple of tensors each); the mesh
    is small, so every shard folds its predecessors' in order."""
    out = []
    for i, own in enumerate(summaries):
        acc = identity(own)
        for earlier in summaries[:i]:
            acc = combine(acc, _to(earlier, _device(own)))
        out.append(acc)
    return out


def _exclusive_suffix(summaries, combine, identity):
    """Mirror of :func:`_exclusive_prefix` from the right: each shard's
    combine of all later shards' summaries."""
    flipped = _exclusive_prefix(summaries[::-1], lambda a, b: combine(b, a), identity)
    return flipped[::-1]


def _left_halos(parts, rows: int, first: torch.Tensor):
    """Shard i's copy of shard i-1's last ``rows`` rows; shard 0 takes
    ``first``."""
    return [first] + [prev[-rows:].to(p.device) for prev, p in zip(parts, parts[1:])]


def _right_halos(parts, rows: int):
    """Shard i's copy of shard i+1's first ``rows`` rows; the last shard
    takes zeros."""
    return [nxt[:rows].to(p.device) for p, nxt in zip(parts, parts[1:])] + [
        torch.zeros_like(parts[-1][:rows])
    ]


def _all_sum(parts):
    """Every shard's copy of the sum of ``parts``, added in shard order on
    shard 0's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


@functools.lru_cache(maxsize=16)
def _band_weights(device: torch.device) -> torch.Tensor:
    # cached per device: a host copy inside the program would be a host sync
    return torch.from_numpy(V._BAND_WEIGHTS).to(device)


def _compose_affine(first, second):
    """The affine map ``y -> a*y + b`` of ``first`` then ``second``."""
    (a1, b1), (a2, b2) = first, second
    return a1 * a2, a2 * b1 + b2


def _sharded_webrtc(bands, logmel, t_global, valid, n_valid: int, mode: str,
                    non_speech_label: float):
    """The webrtc-class detector over the shards (``ops/vad.
    _webrtc_from_bands`` of a fresh stream). Returns per-shard labels."""
    f32 = torch.float32
    t_loc = bands[0].shape[0]
    devs = [b.device for b in bands]
    e = [torch.clamp(b, min=1e-12) for b in bands]
    # the EMA's seed is the signal's first window (shard 0's e[0])
    e0 = [e[0][0].to(dev) for dev in devs]
    alpha = V._ENERGY_EMA_ALPHA
    loc = [
        V._affine_scan(
            torch.where(v, torch.full_like(x, 1.0 - alpha), torch.ones_like(x)),
            torch.where(v, alpha * x, torch.zeros_like(x)),
        )
        for x, v in zip(e, valid)
    ]
    pref = _exclusive_prefix(
        [(a[-1], b[-1]) for a, b in loc], _compose_affine,
        lambda s: (torch.ones_like(s[0]), torch.zeros_like(s[1])),
    )
    ema = [
        (pa[None, :] * a) * s[None, :] + (a * pb[None, :] + b)
        for (a, b), (pa, pb), s in zip(loc, pref, e0)
    ]
    ln_ema = [torch.log(x) for x in ema]
    lng = float(np.float32(np.log(V._NOISE_FLOOR_GROWTH)))
    tt = [t.to(f32)[:, None] * lng for t in t_global]
    loc_min = [
        torch.cummin(torch.where(v, le - t, float("inf")), dim=0).values
        for le, t, v in zip(ln_ema, tt, valid)
    ]
    pref_min = _exclusive_prefix(
        [m[-1] for m in loc_min], torch.minimum, lambda s: torch.full_like(s, float("inf"))
    )
    ln_noise = [t + torch.minimum(m, p[None, :]) for t, m, p in zip(tt, loc_min, pref_min)]
    score = [
        (V._DB_PER_LN * (le - ln)) @ _band_weights(le.device) / float(V._BAND_WEIGHTS.sum())
        for le, ln in zip(ln_ema, ln_noise)
    ]

    # spectral-motion duty cycle: the previous window's normalized spectrum
    # crosses a shard edge as one row (shard 0 starts a fresh stream, whose
    # flux[0] == 0), the ±K box of the moving/active indicators as K-row
    # halos
    k = V._FLUX_BOX_K
    fluxes = []
    prev_p = torch.full_like(logmel[0][0], float("inf"))
    for lm in logmel:
        flux, p = V._spectral_flux(lm, prev_p.to(lm.device))
        fluxes.append(flux)
        prev_p = p[-1]
    noise_sum = [torch.sum(torch.exp(ln), dim=1) for ln in ln_noise]
    ind, active, moving = [], [], []
    for flux, ns, x, sc, v in zip(fluxes, noise_sum, ema, score, valid):
        flux_c = torch.clamp(flux - V._FLUX_NOISE_C * (ns / torch.sum(x, dim=1)), min=0.0)
        active.append((sc > V._SNR_THRESHOLD_DB) & v[:, 0])
        moving.append((flux_c > V._FLUX_MOVE_THRESHOLD) & v[:, 0])
        ind.append(torch.stack([(moving[-1] & active[-1]).to(f32), active[-1].to(f32)], dim=1))
    ind_ext = [
        torch.cat([left, mid, right], dim=0)
        for left, mid, right in zip(
            _left_halos(ind, k, torch.zeros_like(ind[0][:k])), ind, _right_halos(ind, k)
        )
    ]
    frac = []
    for ie, t in zip(ind_ext, t_global):
        s_pad = torch.cat([torch.zeros_like(ie[:1]), torch.cumsum(ie, dim=0)], dim=0)
        e_idx = torch.arange(k, t_loc + k, device=t.device)  # ext rows of the shard's windows
        lo = e_idx - torch.clamp(t, max=k)
        hi = torch.clamp(e_idx + torch.clamp(n_valid - 1 - t, max=k), 0, t_loc + 2 * k - 1)
        sums = s_pad[hi + 1] - s_pad[lo]
        frac.append(sums[:, 0] / torch.clamp(sums[:, 1], min=1.0))

    # sustained-music and transient-train vetoes: the dB energy track
    # crosses shard edges as ±_SYL_LOOKBACK-row halos; every band-pass value
    # a local window's ±_FLUX_BOX_K box reads then has its full ±_SYL_LONG_K
    # context inside the ext array
    big_l = V._SYL_LOOKBACK
    ldb = [
        torch.where(
            v[:, 0],
            V._DB_PER_LN * torch.log(torch.maximum(torch.sum(x, dim=1), ns)),
            0.0,
        )
        for x, ns, v in zip(e, noise_sum, valid)
    ]
    ldb_ext = [
        torch.cat([left, mid, right])
        for left, mid, right in zip(
            _left_halos(ldb, big_l, torch.zeros_like(ldb[0][:big_l])), ldb,
            _right_halos(ldb, big_l),
        )
    ]
    raws = []
    for i, (lx, dev) in enumerate(zip(ldb_ext, devs)):
        ext_idx = torch.arange(t_loc + 2 * big_l, device=dev)
        g_ldb = i * t_loc - big_l + ext_idx
        vm = ((g_ldb >= 0) & (g_ldb < n_valid)).to(f32)
        ps_ldb = V._prefix_pairs(lx, vm)
        mid = ext_idx[big_l : big_l + t_loc]  # ext rows of the shard's windows

        def boxed_am(short_k, long_k):
            """±_FLUX_BOX_K box mean of the |band-pass| of the dB track."""
            band = V._box_mean_prefix(ps_ldb, ext_idx, short_k) - V._box_mean_prefix(
                ps_ldb, ext_idx, long_k
            )
            return V._box_mean_prefix(
                V._prefix_pairs(torch.abs(band) * vm, vm), mid, V._FLUX_BOX_K
            )

        raws.append(
            active[i]
            & moving[i]
            & (frac[i] > V._FLUX_FRAC_THRESHOLD)
            & (boxed_am(V._SYL_SHORT_K, V._SYL_LONG_K) > V._SYL_MOD_THRESHOLD)
            & (boxed_am(V._FAST_SHORT_K, V._SYL_SHORT_K) <= V._FAST_MOD_MAX)
        )
    # hangover: the last raw vote at or before each window (running max of
    # marked global indices) and the next one at or after it (reverse
    # running min)
    loc_last = [
        torch.cummax(torch.where(raw, t, torch.full_like(t, -_FAR)), dim=0).values
        for raw, t in zip(raws, t_global)
    ]
    loc_next = [
        torch.flip(
            torch.cummin(torch.flip(torch.where(raw, t, torch.full_like(t, _FAR)), [0]), dim=0)
            .values,
            [0],
        )
        for raw, t in zip(raws, t_global)
    ]
    pref_last = _exclusive_prefix(
        [m[-1] for m in loc_last], torch.maximum, lambda s: torch.full_like(s, -_FAR)
    )
    suf_next = _exclusive_suffix(
        [m[0] for m in loc_next], torch.minimum, lambda s: torch.full_like(s, _FAR)
    )
    out = []
    for t, ll, pl, ln, sn in zip(t_global, loc_last, pref_last, loc_next, suf_next):
        speech_fuse = t - torch.maximum(ll, pl) < V._HANGOVER_WINDOWS
        if mode == "webrtc":
            # standalone --vad webrtc reads the pre-hangover strength stream;
            # fusion modes the trailing-only one (ops/vad._vad_program)
            pre = torch.minimum(ln, sn) - t < V._PRE_HANGOVER_WINDOWS
            strength = torch.where(
                speech_fuse, 1.0, torch.where(pre, V._PRE_HANGOVER_WEIGHT, 0.0)
            ).to(f32)
            out.append(non_speech_label + (1.0 - non_speech_label) * strength)
        else:
            out.append(torch.where(speech_fuse, 1.0, non_speech_label).to(f32))
    return out


def _sharded_neural(logmel, valid, n_valid: int, nets, non_speech_label: float):
    """The neural detector over the shards: global normalization sums,
    ±CONTEXT-row halos of the normalized features, the net per shard.
    Returns per-shard labels."""
    ctx = CONTEXT
    t_loc = logmel[0].shape[0]
    denom = max(n_valid, 1)
    mean = [
        s / denom
        for s in _all_sum([torch.sum(lm * v, dim=0, keepdim=True) for lm, v in zip(logmel, valid)])
    ]
    var = [
        s / denom
        for s in _all_sum(
            [
                torch.sum(((lm - m) * v) ** 2, dim=0, keepdim=True)
                for lm, m, v in zip(logmel, mean, valid)
            ]
        )
    ]
    x = [
        torch.where(v, (lm - m) / (torch.sqrt(s) + 1e-3), 0.0)
        for lm, m, s, v in zip(logmel, mean, var, valid)
    ]
    out = []
    for i, (left, mid, right, net) in enumerate(
        zip(_left_halos(x, ctx, torch.zeros_like(x[0][:ctx])), x, _right_halos(x, ctx), nets)
    ):
        x_ext = torch.cat([left, mid, right], dim=0)
        # ext rows outside [0, n_valid) in GLOBAL terms (shard 0's left halo,
        # the last shard's right halo, tail padding) are masked, so the net's
        # aux-channel statistics match the monolithic program's
        g_ext = i * t_loc - ctx + torch.arange(t_loc + 2 * ctx, device=x_ext.device)
        vm_ext = ((g_ext >= 0) & (g_ext < n_valid)).to(x_ext.dtype)
        with torch.no_grad():
            probs = net(x_ext, vm_ext)[ctx : ctx + t_loc]
        out.append(1.0 - (1.0 - probs) * (1.0 - non_speech_label))
    return out


def _sharded_program(framed, window: int, frame_rate: int, n_valid: int,
                     nets, non_speech_label: float, mode: str) -> List[torch.Tensor]:
    """The shard body (``ffsubsync_tpu/parallel/vad_shard.py::
    _sharded_program``) over every shard.

    ``framed`` holds one wire-PCM block ``[T_loc, width]`` per shard, on its
    mesh device, all of ``T_loc >= CONTEXT`` rows; rows at or past the
    global index ``n_valid`` are padding. ``nets`` holds each shard's
    :class:`~ffsubsync_tpu_torch.models.neural_vad.NeuralVADNet` (unused
    under ``webrtc``). Returns the labels ``[T_loc]`` of every shard, each on
    its shard's device.
    """
    t_loc = framed[0].shape[0]
    if any(f.shape[0] != t_loc for f in framed) or t_loc < CONTEXT:
        raise ValueError(
            "shards need equal row counts of at least %d, got %r"
            % (CONTEXT, [f.shape[0] for f in framed])
        )
    t_global = [
        i * t_loc + torch.arange(t_loc, device=f.device) for i, f in enumerate(framed)
    ]
    valid = [(t < n_valid)[:, None] for t in t_global]
    fronts = [fused_frontend(f, window, frame_rate) for f in framed]
    logmel = [lm for lm, _bands, _total in fronts]
    webrtc_labels = silero_labels = [None] * len(framed)
    # the backend a mode does not read is not computed (ops/vad._vad_program)
    if mode != "silero":
        webrtc_labels = _sharded_webrtc(
            [bands for _lm, bands, _total in fronts], logmel, t_global, valid,
            n_valid, mode, non_speech_label,
        )
    if mode != "webrtc":
        silero_labels = _sharded_neural(logmel, valid, n_valid, nets, non_speech_label)
    return [V._select_labels(mode, w, s) for w, s in zip(webrtc_labels, silero_labels)]


class ShardedDetector:
    """``detector(pcm) -> LazySpeechSignal``, one signal's windows split over
    ``mesh`` (``ffsubsync_tpu/parallel/vad_shard.py::make_sharded_detector``).

    :meth:`stage` puts the staged shards on their devices and :meth:`run`
    is the sharded program from them to the joined labels; calling the
    detector does both.
    """

    def __init__(self, mesh: Sequence[torch.device], mode: str, sample_rate: int,
                 frame_rate: int, non_speech_label: float) -> None:
        self.mesh = tuple(torch.device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("a sharded detector needs a mesh of at least one device")
        self.mode = mode
        self.sample_rate = sample_rate
        self.frame_rate = frame_rate
        self.non_speech_label = non_speech_label
        # one copy of the weights per distinct device; webrtc reads no net
        rate = analysis_rate(frame_rate, sample_rate)
        loaded = {
            dev: None if mode == "webrtc" else load_net(rate, dev)
            for dev in dict.fromkeys(self.mesh)
        }
        self.nets = [loaded[dev] for dev in self.mesh]

    def stage(self, pcm) -> Tuple[List[torch.Tensor], int, int, int]:
        """Host staging, padded to ``D`` equal shards of ``max(ceil(n / D),
        CONTEXT)`` rows of wire silence, each shard copied to its device.
        Returns ``(shards, window, analysis rate, n_windows)``."""
        pcm = V._pcm_bytes_to_i16(pcm)
        framed, rate, window, n_windows = prepare_staged_input(
            pcm, self.frame_rate, self.sample_rate
        )
        d = len(self.mesh)
        per = max(-(-n_windows // d), CONTEXT)
        if per * d > n_windows:
            # wire-format silence rows, not bare zeros: the packed 6-bit
            # wire's silence is a nonzero byte pattern
            framed = np.concatenate(
                [framed, wire_silence_rows(framed, per * d - n_windows, window)]
            )
        shards = [
            torch.from_numpy(framed[i * per : (i + 1) * per]).to(dev)
            for i, dev in enumerate(self.mesh)
        ]
        return shards, window, rate, n_windows

    def run(self, shards, window: int, rate: int, n_windows: int) -> torch.Tensor:
        """The sharded program; the shard labels joined on ``mesh[0]`` and
        cut to ``[n_windows]``, so the aligner reads one device tensor."""
        labels = _sharded_program(
            shards, window, rate, n_windows, self.nets, self.non_speech_label, self.mode
        )
        return torch.cat([lab.to(self.mesh[0]) for lab in labels])[:n_windows]

    def __call__(self, pcm) -> LazySpeechSignal:
        shards, window, rate, n_windows = self.stage(pcm)
        return LazySpeechSignal([(self.run(shards, window, rate, n_windows), n_windows)])


def make_sharded_detector(mesh: Sequence[torch.device], mode: str, sample_rate: int,
                          frame_rate: int, non_speech_label: float) -> ShardedDetector:
    """A detector running the whole VAD of one signal as one sharded call
    over ``mesh`` (a sequence of devices, which may repeat one). ``mode`` is
    "webrtc", "silero" or a fusion strategy."""
    return ShardedDetector(mesh, mode, sample_rate, frame_rate, non_speech_label)


def maybe_sharded_detector(vad: str, sample_rate: int, frame_rate: int,
                           non_speech_label: float,
                           device: torch.device) -> Optional[ShardedDetector]:
    """Product wiring: a sharded detector when the environment asks for one.

    None unless ``FFS_TPU_SP_VAD=1``, the ``--vad`` mode maps onto the
    fused device program (auditok's host tokenizer has no sharded form),
    and :func:`~ffsubsync_tpu_torch.device.local_mesh` of ``device`` holds
    at least two devices. The media layer then buffers the whole signal and
    runs one sharded call instead of the chunked pipeline.
    """
    if os.environ.get("FFS_TPU_SP_VAD") != "1":
        return None
    name = vad.split("subs_then_")[-1]
    if "fused" in name:
        mode = name.split(":", 1)[1] if ":" in name else "weighted"
    elif "webrtc" in name:
        mode = "webrtc"
    elif "silero" in name:
        mode = "silero"
    else:
        return None
    mesh = local_mesh(device)
    if len(mesh) < 2:
        return None
    logger.info("sequence-parallel VAD: sharding the signal over %d devices", len(mesh))
    return make_sharded_detector(mesh, mode, sample_rate, frame_rate, non_speech_label)
