# -*- coding: utf-8 -*-
"""Synthetic references whose speech spans are known, made from a seed.

The speech model is that of the program's fixture generator (pulse-train
excitation through continuously moving formants, overlap-added by 60 ms
hops, a 4 Hz syllabic envelope peaking at each span's start), rewritten
here in PyTorch so that the benchmark owns it and it runs on the card: a
bank of utterances is made in a few batched calls, and each span of a film
takes the head of one of them. Spans last 1-4 s and gaps 0.8-4 s; each
film has the same number of spans, its gaps scaled to fill the film, so
every seed gives the same amount of work.

Each request's subtitles are the film's spans, scaled by a framerate ratio
for one request in four (the program corrects by the inverse ratio) and
shifted by an offset drawn uniformly within the workload's bound.
"""
import math
import os
import struct

import numpy as np
import torch

# ffsubsync's framerate ratios (constants.FRAMERATE_RATIOS upstream)
FRAMERATE_RATIOS = (24.0 / 23.976, 25.0 / 23.976, 25.0 / 24.0)

SPAN_S = (1.0, 4.0)
GAP_S = (0.8, 4.0)
TAIL_S = 6.0  # no span ends within this of the film's end


def draw_spans(rng, duration_s, lead_s, n_spans):
    """``n_spans`` (start, end) speech spans in seconds: lengths and gaps
    drawn uniformly, the gaps then scaled so that the spans fill the film
    from ``lead_s`` to ``TAIL_S`` before its end."""
    lengths = rng.uniform(*SPAN_S, size=n_spans)
    gaps = rng.uniform(*GAP_S, size=n_spans - 1)
    room = duration_s - TAIL_S - lead_s - lengths.sum()
    if room <= 0:
        raise ValueError("%d spans do not fit into %.0f s" % (n_spans, duration_s))
    gaps *= room / gaps.sum()
    starts = lead_s + np.concatenate([[0.0], np.cumsum(lengths[:-1] + gaps)])
    return [(float(a), float(a + n)) for a, n in zip(starts, lengths)]


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=torch.float64)


def utterance_bank(gen, n, seconds, rate, device):
    """``n`` utterances of ``seconds`` each, float32 [n, samples] peaking
    at 1: pitch with a phrase-scale glide and slow wander, pulses with
    per-period shimmer and breath noise, filtered per 60 ms hop by three
    formants that walk in log-frequency (reflected at their ranges) and
    crossfaded by Hann overlap-add."""
    s = int(seconds * rate)
    f64 = torch.float64
    t = torch.arange(s, device=device, dtype=f64) / rate
    f0 = _uniform(gen, (n, 1), 100.0, 260.0, device)
    glide = 1.0 + _uniform(gen, (n, 1), 0.15, 0.3, device) * torch.sin(
        2 * math.pi * _uniform(gen, (n, 1), 0.6, 1.6, device) * t
        + _uniform(gen, (n, 1), 0.0, 6.28, device))
    wander = 1.0 + 0.04 * torch.cumsum(
        torch.randn((n, s), generator=gen, device=device, dtype=f64), dim=1) / math.sqrt(s)
    phase = torch.cumsum(f0 * glide * wander, dim=1) / rate
    frac = phase - torch.floor(phase)
    sharp = _uniform(gen, (n, 1), 150.0, 450.0, device)
    exc = torch.exp(-sharp * (frac - 0.08) ** 2)
    periods = torch.floor(phase).long()
    shimmer = 1.0 + 0.3 * torch.randn((n, int(periods.max()) + 1), generator=gen,
                                      device=device, dtype=f64)
    exc = exc * torch.gather(shimmer, 1, periods)
    exc = exc + _uniform(gen, (n, 1), 0.06, 0.12, device) * torch.randn(
        (n, s), generator=gen, device=device, dtype=f64)

    hop = max(int(0.06 * rate), 2)
    width = 2 * hop
    # one hop of discarded signal each side, so every kept sample lies
    # where the Hann windows overlap-add to 1
    exc = torch.nn.functional.pad(exc[:, None, :], (hop, hop), mode="reflect")[:, 0]
    total = s + 2 * hop
    n_frames = total // hop + 1
    exc = torch.nn.functional.pad(exc, (0, (n_frames + 1) * hop - total))
    frames = exc.unfold(1, width, hop)[:, :n_frames]  # [n, F, width]
    win = torch.hann_window(width, periodic=False, dtype=f64, device=device)
    freqs = torch.fft.rfftfreq(width, 1.0 / rate, dtype=f64, device=device)
    lo_c = torch.tensor([250.0, 850.0, 2200.0], dtype=f64, device=device).log()
    hi_c = torch.tensor([850.0, 2300.0, 3400.0], dtype=f64, device=device).log()
    start = torch.stack([_uniform(gen, (n,), 300.0, 800.0, device),
                         _uniform(gen, (n,), 900.0, 2200.0, device),
                         _uniform(gen, (n,), 2300.0, 3200.0, device)], dim=1).log()
    walk = start[:, None, :] + torch.cumsum(
        _uniform(gen, (n, n_frames, 3), -0.3, 0.3, device), dim=1)
    span = hi_c - lo_c
    folded = torch.remainder(walk - lo_c, 2 * span)
    folded = torch.where(folded > span, 2 * span - folded, folded)
    centers = torch.exp(lo_c + folded)  # [n, F, 3]
    bw = torch.tensor([0.12, 0.14, 0.18], dtype=f64, device=device)
    gain = 0.03 + torch.exp(
        -0.5 * ((freqs[None, None, :, None] - centers[:, :, None, :])
                / (bw * centers)[:, :, None, :]) ** 2).sum(dim=-1)
    gain = gain / (1.0 + (freqs / 3000.0) ** 2)
    shaped = torch.fft.irfft(torch.fft.rfft(frames * win, dim=-1) * gain, n=width, dim=-1)
    # overlap-add: each frame's halves land on consecutive hops
    halves = shaped.reshape(n, n_frames, 2, hop)
    out = torch.zeros((n, n_frames + 1, hop), dtype=f64, device=device)
    out[:, :-1] += halves[:, :, 0]
    out[:, 1:] += halves[:, :, 1]
    wsum = torch.zeros((n_frames + 1, hop), dtype=f64, device=device)
    wh = win.reshape(2, hop)
    wsum[:-1] += wh[0]
    wsum[1:] += wh[1]
    out = out.reshape(n, -1)[:, hop: hop + s] / torch.clamp(wsum.reshape(-1)[hop: hop + s], min=0.5)
    out = out / (out.abs().amax(dim=1, keepdim=True) + 1e-9)
    return out.to(torch.float32)


def film_pcm(gen, spans, duration_s, rate, bank, bank_idx, speech_level, noise_level):
    """int16 PCM of one film on the bank's device: noise everywhere, each
    span the head of its bank utterance under the syllabic envelope."""
    device = bank.device
    n = int(duration_s * rate)
    x = torch.randn((n,), generator=gen, device=device, dtype=torch.float32) * noise_level
    t = torch.arange(bank.shape[1], device=device, dtype=torch.float64) / rate
    env = (0.55 + 0.45 * torch.sin(2 * math.pi * 4.0 * t + math.pi / 2)).to(torch.float32)
    shaped = speech_level * bank * env
    for (a, b), k in zip(spans, bank_idx):
        i0, i1 = int(a * rate), min(int(b * rate), n)
        if i1 > i0:
            x[i0:i1] += shaped[int(k), : i1 - i0]
    return torch.clamp(x * 32767.0, -32768.0, 32767.0).to(torch.int16)


def write_wav(path, pcm_i16, rate):
    """Mono 16-bit PCM WAV."""
    data = np.ascontiguousarray(pcm_i16, dtype="<i2")
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data.nbytes) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", data.nbytes))
        data.tofile(f)


def srt_stamp(t):
    ms = int(round(t * 1000))
    return "%02d:%02d:%02d,%03d" % (ms // 3600000, ms // 60000 % 60, ms // 1000 % 60, ms % 1000)


def write_srt(path, spans, ratio, offset_s):
    """One cue per span at ``span * ratio + offset_s`` seconds."""
    with open(path, "w") as f:
        for i, (a, b) in enumerate(spans):
            f.write("%d\n%s --> %s\nline %d\n\n"
                    % (i + 1, srt_stamp(a * ratio + offset_s), srt_stamp(b * ratio + offset_s), i + 1))


def subtitle_plan(rng, n_requests, offset_bound_s, scaled_every):
    """(ratio, offset) of each request: offsets uniform in
    +-``offset_bound_s``; exactly one request in ``scaled_every`` (at
    positions drawn from the seed) scaled by one of the framerate ratios."""
    offsets = rng.uniform(-offset_bound_s, offset_bound_s, size=n_requests)
    ratios = np.ones(n_requests)
    for block in range(0, n_requests, scaled_every):
        k = block + int(rng.integers(scaled_every))
        if k < n_requests:
            ratios[k] = FRAMERATE_RATIOS[int(rng.integers(len(FRAMERATE_RATIOS)))]
    return [(float(r), float(o)) for r, o in zip(ratios, offsets)]


class Media:
    """A seed's pool of films written as WAVs, and the subtitles of each
    request, in ``workdir``: subtitle file ``j`` holds film ``j % films``'s
    spans at ``plan[j]``'s (ratio, offset)."""

    def __init__(self, workdir, wavs, spans, plan, srt_paths):
        self.workdir, self.wavs, self.spans = workdir, wavs, spans
        self.plan, self.srt_paths = plan, srt_paths


def make_media(workdir, seed, config, traffic, device):
    """Write the pool of films and every request's subtitles. Returns a
    :class:`Media`; its ``timings`` hold the seconds of each step."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    rate, duration = config["analysis_rate_hz"], config["minutes"] * 60.0
    spans = [draw_spans(rng, duration, traffic["lead_seconds"], config["cues_per_film"])
             for _ in range(traffic["films"])]
    bank = utterance_bank(gen, traffic["bank_utterances"], SPAN_S[1], rate, device)
    wavs = []
    for i, film_spans in enumerate(spans):
        idx = rng.integers(bank.shape[0], size=len(film_spans))
        pcm = film_pcm(gen, film_spans, duration, rate, bank, idx,
                       config["speech_level"], config["noise_level"]).cpu().numpy()
        wavs.append(os.path.join(workdir, "film%d.wav" % i))
        write_wav(wavs[-1], pcm, rate)
    plan = subtitle_plan(rng, traffic["subtitle_files"], traffic["offset_bound_seconds"],
                         traffic["scaled_every"])
    srt_paths = []
    for k, (ratio, offset) in enumerate(plan):
        srt_paths.append(os.path.join(workdir, "in%d.srt" % k))
        write_srt(srt_paths[-1], spans[k % len(wavs)], ratio, offset)
    return Media(workdir, wavs, spans, plan, srt_paths)
