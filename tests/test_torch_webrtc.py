# -*- coding: utf-8 -*-
"""The port's webrtc-class detector (``_webrtc_from_bands``) against the JAX
package's own function, fed the same numpy features: both label streams
and the 7-field carried state, fresh and carried streams, padding, fixtures
that trip each gate, and a movie-scale chunk (float32 prefix-sum rounding,
see ``test_long_chunk_label_agreement``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffsubsync_tpu.ops import vad as jvad
from ffsubsync_tpu_torch.ops import vad as tvad

torch.set_num_threads(1)

K = jvad._FLUX_BOX_K
L = jvad._SYL_LOOKBACK
STATE_RTOL = 1e-4
LABEL_AGREEMENT = 0.999


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _fresh_state():
    return dict(
        ema=np.full(6, np.inf, np.float32),
        noise=np.full(6, np.inf, np.float32),
        prev_p=np.full(40, np.inf, np.float32),
        prev_m=np.zeros((K, 2), np.float32),
        prev_m_len=0,
        prev_ldb=np.zeros(L, np.float32),
        prev_ldb_len=0,
    )


_FIELDS = ("ema", "noise", "prev_p", "prev_m", "prev_m_len", "prev_ldb", "prev_ldb_len")


def _run_ref(bands, logmel, n_valid, st):
    out = jvad._webrtc_from_bands(
        jnp.asarray(bands), jnp.asarray(logmel), jnp.int32(n_valid),
        jnp.asarray(st["ema"]), jnp.asarray(st["noise"]), jnp.asarray(st["prev_p"]),
        jnp.asarray(st["prev_m"]), jnp.int32(st["prev_m_len"]),
        jnp.asarray(st["prev_ldb"]), jnp.int32(st["prev_ldb_len"]),
    )
    out = [np.asarray(o) for o in out]
    return out[0], out[1], dict(zip(_FIELDS, out[2:]))


def _run_port(bands, logmel, n_valid, st):
    t = torch.from_numpy
    out = tvad._webrtc_from_bands(
        t(bands), t(logmel), n_valid, t(st["ema"]), t(st["noise"]),
        t(st["prev_p"]), t(st["prev_m"]), int(st["prev_m_len"]),
        t(st["prev_ldb"]), int(st["prev_ldb_len"]),
    )
    out = [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]
    return out[0], out[1], dict(zip(_FIELDS, out[2:]))


def _compare(ref, port, n_valid):
    (r_s, r_f, r_st), (p_s, p_f, p_st) = ref, port
    agree_s = np.mean(r_s[:n_valid] == p_s[:n_valid])
    agree_f = np.mean(r_f[:n_valid] == p_f[:n_valid])
    assert agree_s >= LABEL_AGREEMENT, agree_s
    assert agree_f >= LABEL_AGREEMENT, agree_f
    for name in _FIELDS:
        np.testing.assert_allclose(
            p_st[name], r_st[name], rtol=STATE_RTOL, err_msg=name
        )
    return agree_s, agree_f


def _random_logmel(rng, t, m=40):
    base = np.cumsum(rng.randn(t, m) * 0.2, axis=0) * 0.1
    return (base + rng.randn(t, m)).astype(np.float32)


def _random_features(seed, t):
    rng = np.random.RandomState(seed)
    bands = np.exp(rng.randn(t, 6)).astype(np.float32)
    bands[t // 4 : t // 4 + 60] *= 300.0
    bands[(3 * t) // 4 : (3 * t) // 4 + 30] *= 500.0
    return bands, _random_logmel(rng, t)


def _carried_state(seed):
    rng = np.random.RandomState(seed)
    act = (rng.rand(K) > 0.3).astype(np.float32)
    return dict(
        ema=np.exp(rng.randn(6)).astype(np.float32),
        noise=(np.exp(rng.randn(6)) * 0.1).astype(np.float32),
        prev_p=rng.dirichlet(np.ones(40)).astype(np.float32),
        prev_m=np.stack([(rng.rand(K) > 0.5).astype(np.float32) * act, act], axis=1),
        prev_m_len=K,
        prev_ldb=(rng.randn(L) * 4.0 + 20.0).astype(np.float32),
        prev_ldb_len=L,
    )


@pytest.mark.parametrize("carry_in", [False, True])
def test_matches_reference_fresh_and_carried(carry_in):
    bands, logmel = _random_features(42, 400)
    st = _carried_state(1) if carry_in else _fresh_state()
    _compare(_run_ref(bands, logmel, 400, st), _run_port(bands, logmel, 400, st), 400)


def test_two_chunks_with_carried_state():
    """Each side threads its own state from chunk 1 into chunk 2."""
    bands, logmel = _random_features(7, 900)
    st_r = st_p = _fresh_state()
    for lo, hi in ((0, 380), (380, 900)):
        ref = _run_ref(bands[lo:hi], logmel[lo:hi], hi - lo, st_r)
        port = _run_port(bands[lo:hi], logmel[lo:hi], hi - lo, st_p)
        _compare(ref, port, hi - lo)
        st_r, st_p = ref[2], port[2]


def test_partial_carried_state_lengths():
    """A first chunk shorter than the carried windows leaves partial state."""
    bands, logmel = _random_features(8, 140)
    st_r = st_p = _fresh_state()
    for lo, hi in ((0, 40), (40, 140)):
        ref = _run_ref(bands[lo:hi], logmel[lo:hi], hi - lo, st_r)
        port = _run_port(bands[lo:hi], logmel[lo:hi], hi - lo, st_p)
        _compare(ref, port, hi - lo)
        st_r, st_p = ref[2], port[2]
    assert int(st_p["prev_m_len"]) == K and int(st_p["prev_ldb_len"]) == L


def test_padding_is_inert():
    """Rows past n_valid change neither labels nor carried state."""
    bands, logmel = _random_features(3, 257)
    st = _fresh_state()
    s1, f1, st1 = _run_port(bands, logmel, 257, st)
    pad_b = np.zeros((512, 6), np.float32)
    pad_b[:257] = bands
    pad_l = np.zeros((512, 40), np.float32)
    pad_l[:257] = logmel
    s2, f2, st2 = _run_port(pad_b, pad_l, 257, st)
    np.testing.assert_array_equal(s1, s2[:257])
    np.testing.assert_array_equal(f1, f2[:257])
    for name in _FIELDS:
        np.testing.assert_allclose(st2[name], st1[name], rtol=1e-5, err_msg=name)
    # and the reference agrees on the padded layout too
    _compare(_run_ref(pad_b, pad_l, 257, st), (s2, f2, st2), 257)


def _gate_fixture(kind, seed=0, t=1200):
    """Quiet floor, then a loud stretch (windows 300..900) whose features
    either look like speech or trip exactly one gate:

    - ``speech``: moving spectrum, syllabic (4 Hz) energy modulation;
    - ``motion``: syllabic energy but a frozen spectrum (no motion);
    - ``sustained``: moving spectrum, steady energy (sustained-music veto);
    - ``transient``: moving spectrum, energy spiky at the window scale
      (transient-train veto).
    """
    rng = np.random.RandomState(seed)
    n = np.arange(t)
    bands = (np.exp(rng.randn(t, 6) * 0.1) * 1e-3).astype(np.float32)
    logmel = (rng.randn(t, 40) * 0.05).astype(np.float32)  # near-frozen floor
    loud = slice(300, 900)
    if kind == "transient":
        gain_db = np.where(rng.rand(600) < 0.5, 40.0, 20.0)
    elif kind == "sustained":
        gain_db = np.full(600, 30.0)
    else:
        gain_db = 30.0 + 8.0 * np.sin(2 * np.pi * 4.0 * n[loud] / 100.0)
    bands[loud] *= (10.0 ** (gain_db / 10.0))[:, None].astype(np.float32)
    if kind == "motion":
        logmel[loud] = rng.randn(1, 40).astype(np.float32) * 2.0
    else:
        logmel[loud] = (rng.randn(600, 40) * 2.0).astype(np.float32)
    return bands, logmel


@pytest.mark.parametrize("kind", ["speech", "motion", "sustained", "transient"])
def test_gate_fixtures(kind):
    bands, logmel = _gate_fixture(kind)
    st = _fresh_state()
    ref = _run_ref(bands, logmel, len(bands), st)
    port = _run_port(bands, logmel, len(bands), st)
    _compare(ref, port, len(bands))
    # the loud stretch's interior: its step edges are real energy modulation
    votes = port[1][400:800].mean()
    if kind == "speech":
        assert votes > 0.9, votes
    else:  # the gate under test vetoes the loud stretch
        assert votes < 0.05, votes


def test_long_chunk_label_agreement():
    """~60k windows (10 min), fed directly with features. The dB prefix
    sums of the modulation vetoes grow to ~1e6 here (~1e7 over a 45-min
    chunk), where float32 spacing is ~0.1-1, so box means taken as prefix
    differences round differently under torch.cumsum than under the
    reference's two-level scan; windows near the 0.75 / 2.5 dB thresholds
    can flip. Both stay float32, as the reference is."""
    t = 60000
    rng = np.random.RandomState(123)
    n = np.arange(t)
    # alternating speech-like and music-like minutes over a noise floor
    gain_db = np.where(
        (n // 3000) % 2 == 0,
        25.0 + 8.0 * np.sin(2 * np.pi * 4.0 * n / 100.0),
        25.0 + 0.3 * np.sin(2 * np.pi * 0.2 * n / 100.0),
    )
    gain_db = np.where(rng.rand(t) < 0.15, -10.0, gain_db)  # pauses
    bands = (np.exp(rng.randn(t, 6) * 0.3) * 10.0 ** (gain_db / 10.0)[:, None]).astype(
        np.float32
    )
    logmel = _random_logmel(rng, t)
    st = _fresh_state()
    agree_s, agree_f = _compare(_run_ref(bands, logmel, t, st), _run_port(bands, logmel, t, st), t)
    print("60k-window label agreement: strength %.6f fuse %.6f" % (agree_s, agree_f))


def test_affine_scan_matches_sequential():
    rng = np.random.RandomState(9)
    a = rng.uniform(0.5, 1.0, size=(1000, 3)).astype(np.float64)
    b = rng.randn(1000, 3)
    big_a, big_b = tvad._affine_scan(torch.from_numpy(a), torch.from_numpy(b))
    y0 = rng.randn(3)
    y = y0.copy()
    for i in range(1000):
        y = a[i] * y + b[i]
        np.testing.assert_allclose(big_a[i].numpy() * y0 + big_b[i].numpy(), y, rtol=1e-9)
