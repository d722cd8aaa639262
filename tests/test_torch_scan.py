# -*- coding: utf-8 -*-
"""The scans of the webrtc-class detector (``ops/scan.py``).

On the CPU: the plain version (what a CPU tensor runs) and an emulation of
the CUDA kernel's order of operations (``csrc/scan.cu``: 4096-row tiles of
1024 threads x 4 rows, a serial scan per thread, Kogge-Stone shuffles per
warp and over the 32 warp totals, the tile totals scanned by one block,
then tile prefix o local value), each against a sequential loop in numpy,
for every op, width and edge size; then the emulation fed through
``_webrtc_from_bands`` at 60,000 windows against the JAX package's at the
bars of ``tests/test_torch_webrtc.py``. The kernel itself runs only on the
card: the ``cuda``-marked cases hold it against the plain version and,
bit for bit, against the emulation (``chip_smoke.py`` holds it against the
plain version at every path's shapes).
"""
import numpy as np
import pytest
import torch

from ffsubsync_tpu_torch.device import host_to_device
from ffsubsync_tpu_torch.ops import scan
from ffsubsync_tpu_torch.ops import vad as tvad

torch.set_num_threads(1)

TILE = scan.TILE_ROWS
THREADS, ROWS = 1024, 4  # csrc/scan.cu's kThreads, kRowsPerThread
# sizes: one row, under one tile, one tile, a tile and a row, 4096·k ± 1,
# and 60,000 (15 tiles, the last one ragged)
SIZES = (1, 100, TILE - 1, TILE, TILE + 1, 3 * TILE - 1, 3 * TILE + 1, 60000)
# (op, dtype, reverse): the detector's scans and the kernel's other cases
CASES = [("add", np.float32, False), ("min", np.float32, False), ("max", np.float32, False),
         ("max", np.int32, False), ("min", np.int32, True), ("min", np.int32, False),
         ("max", np.int32, True), ("min", np.float32, True)]
INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max
FAR = 1 << 30  # the hangover's sentinel
# a float32 prefix sum against float64: within this share of the prefix's
# sum of |x| (n·2^-24 would be the sequential worst case; these stay far
# inside it)
ADD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _inputs(op, dtype, n, c, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.int32:
        # hangover-like: marked indices among sentinels
        idx = np.arange(n * c, dtype=np.int32).reshape(n, c)
        sentinel = -FAR if op == "max" else FAR
        return np.where(rng.rand(n, c) < 0.01, idx, sentinel).astype(np.int32)
    return (rng.randn(n, c) * 30.0).astype(np.float32)


def _sequential(x, op, reverse=False):
    """The scan as a loop, float64 for sums."""
    x = x[::-1] if reverse else x
    out = np.empty(x.shape, np.float64 if op == "add" else x.dtype)
    acc = x[0].astype(out.dtype)
    out[0] = acc
    fn = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    for i in range(1, len(x)):
        acc = fn(acc, x[i])
        out[i] = acc
    return out[::-1] if reverse else out


def _check_against_loop(got, x, op, reverse):
    want = _sequential(x, op, reverse)
    if op == "add":
        scale = _sequential(np.abs(x).astype(np.float64), "add", reverse)
        assert np.all(np.abs(got - want) <= ADD_RTOL * scale + 1e-6)
    else:
        np.testing.assert_array_equal(got, want)


# ---- an emulation of csrc/scan.cu, in float32 on the CPU ----

def _identity(op, dtype):
    if op == "affine":
        return (1.0, -0.0)
    if dtype == torch.int32:
        return (INT_MAX,) if op == "min" else (INT_MIN,)
    return {"add": (-0.0,), "min": (float("inf"),), "max": (float("-inf"),)}[op]


def _combiner(op, dtype):
    """The kernel's combine of (earlier, later) on tuples of tensors."""
    if op == "affine":
        return lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1])
    if op == "add":
        return lambda l, r: (l[0] + r[0],)
    if dtype == torch.int32:
        pick = (lambda l, r: r < l) if op == "min" else (lambda l, r: r > l)
        return lambda l, r: (torch.where(pick(l[0], r[0]), r[0], l[0]),)
    keep = (lambda l, r: (l < r) | (l != l)) if op == "min" else (lambda l, r: (l > r) | (l != l))
    return lambda l, r: (torch.where(keep(l[0], r[0]), l[0], r[0]),)


def _full(like, value):
    return torch.full_like(like, value)


def _shift(v, ident, d):
    """Each lane's value d lanes down the last axis (identity below d)."""
    return tuple(torch.cat([_full(t[..., :d], i), t[..., :-d]], dim=-1) for t, i in zip(v, ident))


def _warp_scan(v, comb, ident):
    """Kogge-Stone over the last axis (32 lanes), as the shuffles do."""
    lane = torch.arange(32)
    for d in (1, 2, 4, 8, 16):
        new = comb(_shift(v, ident, d), v)
        v = tuple(torch.where(lane >= d, n, o) for n, o in zip(new, v))
    return v


def _tile_scan(v, comb, ident):
    """csrc/scan.cu's tile_scan over a batch: ``v`` is a tuple of
    ``[B, THREADS, ROWS]``; returns each row's local inclusive value."""
    b = v[0].shape[0]
    rows = [tuple(t[..., i] for t in v) for i in range(ROWS)]
    for i in range(1, ROWS):
        rows[i] = comb(rows[i - 1], rows[i])
    incl = _warp_scan(tuple(t.reshape(b, 32, 32) for t in rows[-1]), comb, ident)
    warp_incl = _warp_scan(tuple(t[..., 31] for t in incl), comb, ident)
    warp_excl = tuple(t[..., None].expand(b, 32, 32) for t in _shift(warp_incl, ident, 1))
    prefix = comb(warp_excl, _shift(incl, ident, 1))
    prefix = tuple(t.reshape(b, THREADS) for t in prefix)
    out = [comb(prefix, r) for r in rows]
    return tuple(torch.stack([o[k] for o in out], dim=-1) for k in range(len(v)))


def emulate(xs, op, reverse=False):
    """The kernel's three steps on a tuple of ``[N, C]`` (or ``[N]``)
    tensors: the local scan of every tile, the tile totals scanned, each
    value combined with the earlier tiles' total."""
    dtype = xs[0].dtype
    comb, ident = _combiner(op, dtype), _identity(op, dtype)
    flat = xs[0].dim() == 1
    xs = tuple(x[:, None] if flat else x for x in xs)
    if reverse:
        xs = tuple(torch.flip(x, [0]) for x in xs)
    n, c = xs[0].shape
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n
    v = tuple(torch.cat([x, _full(x[:1].expand(pad, c), i)]).T.reshape(c * n_tiles, THREADS, ROWS)
              for x, i in zip(xs, ident))
    local = _tile_scan(v, comb, ident)
    if n_tiles > 1:
        if n_tiles > TILE:
            raise ValueError("the emulation scans the tile totals in one step")
        totals = tuple(t.reshape(c, n_tiles, TILE)[..., -1] for t in local)
        tot = tuple(torch.cat([t, _full(t[:, :1].expand(c, TILE - n_tiles), i)], dim=1)
                    .reshape(c, THREADS, ROWS) for t, i in zip(totals, ident))
        tot = _tile_scan(tot, comb, ident)
        tot = comb(tuple(_full(t, i) for t, i in zip(tot, ident)), tot)  # the carry seed
        incl = tuple(t.reshape(c, TILE)[:, :n_tiles] for t in tot)
        prefix = _shift(incl, ident, 1)
    else:
        prefix = tuple(_full(t.reshape(c, 1, TILE)[..., 0], i) for t, i in zip(local, ident))
    local = tuple(t.reshape(c, n_tiles, TILE) for t in local)
    out = comb(tuple(p[..., None] for p in prefix), local)
    out = tuple(t.reshape(c, n_tiles * TILE)[:, :n].T for t in out)
    if reverse:
        out = tuple(torch.flip(t, [0]) for t in out)
    return tuple(t[:, 0] if flat else t.contiguous() for t in out)


def _emulated_scan_cols(x, op, reverse=False):
    return emulate((x,), op, reverse)[0]


def _emulated_affine_scan(a, b):
    return emulate((a, b), "affine")


# ---- the plain version and the emulation against a loop ----

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c", (1, 2, 6))
@pytest.mark.parametrize("op,dtype,reverse", CASES)
def test_scan_cols_plain_and_emulation_against_a_loop(op, dtype, reverse, c, n):
    x = _inputs(op, dtype, n, c, seed=n + c)
    for fn in (scan.scan_cols, _emulated_scan_cols):
        got = fn(torch.from_numpy(x), op, reverse).numpy()
        assert got.dtype == x.dtype and got.shape == x.shape
        _check_against_loop(got, x, op, reverse)
    # the one-dimensional form the hangover scans
    if c == 1:
        got = _emulated_scan_cols(torch.from_numpy(x[:, 0]), op, reverse).numpy()
        _check_against_loop(got[:, None], x, op, reverse)


def _affine_inputs(n, c, seed, n_valid=None):
    """The EMA's coefficients: a = 0.65, b = 0.35 e on valid rows,
    identities (1, 0) on the padded rows from ``n_valid`` on."""
    rng = np.random.RandomState(seed)
    e = np.exp(rng.randn(n, c)).astype(np.float32)
    valid = (np.arange(n) < (n if n_valid is None else n_valid))[:, None]
    a = np.where(valid, np.full((n, c), 0.65, np.float32), np.float32(1.0))
    b = np.where(valid, np.float32(0.35) * e, np.float32(0.0)).astype(np.float32)
    return a, b


def _affine_loop(a, b, y0):
    """y after each row of ``y -> a*y + b`` from ``y0``, in float64."""
    ys, y = [], y0.astype(np.float64)
    for ai, bi in zip(a.astype(np.float64), b.astype(np.float64)):
        y = ai * y + bi
        ys.append(y)
    return np.array(ys)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c", (1, 6))
def test_affine_scan_plain_and_emulation_against_a_loop(c, n):
    a, b = _affine_inputs(n, c, seed=n * 7 + c)
    y0 = np.exp(np.random.RandomState(n).randn(c)).astype(np.float32)
    want = _affine_loop(a, b, y0)
    for fn in (scan.affine_scan, _emulated_affine_scan):
        big_a, big_b = fn(torch.from_numpy(a), torch.from_numpy(b))
        got = big_a.numpy().astype(np.float64) * y0 + big_b.numpy()
        # the products 0.65^k underflow to 0 past ~1,700 rows, as the
        # reference's do; y then rides on big_b alone
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


@pytest.mark.parametrize("n_valid", (1, 1000, TILE + 5))
def test_identity_padding_passes_the_prefix_through(n_valid):
    """Rows past ``n_valid`` are (1, 0): their scanned pair is the last
    valid row's, in the plain version and the emulation, up to the
    rounding of a product grouped otherwise (both group the valid rows by
    position)."""
    n = 3 * TILE + 17
    a, b = _affine_inputs(n, 6, seed=n_valid, n_valid=n_valid)
    for fn in (scan.affine_scan, _emulated_affine_scan):
        for got in fn(torch.from_numpy(a), torch.from_numpy(b)):
            got = got.numpy()
            last = np.repeat(got[n_valid - 1: n_valid], n - n_valid, 0)
            np.testing.assert_allclose(got[n_valid:], last, rtol=1e-6, atol=0)


@pytest.mark.parametrize("fn", (scan.scan_cols, _emulated_scan_cols), ids=("plain", "emulated"))
def test_hangover_sentinels(fn):
    """No raw vote: the running max stays at -(1 << 30) and the reverse
    running min at 1 << 30; one vote at row r reaches every later row
    (max) and every earlier row (reverse min)."""
    n, r = 2 * TILE + 3, TILE + 1
    none_max = torch.full((n,), -FAR, dtype=torch.int32)
    none_min = torch.full((n,), FAR, dtype=torch.int32)
    assert torch.equal(fn(none_max, "max"), none_max)
    assert torch.equal(fn(none_min, "min", reverse=True), none_min)
    t = torch.arange(n, dtype=torch.int32)
    vote = t == r
    last = fn(torch.where(vote, t, -FAR), "max")
    nxt = fn(torch.where(vote, t, FAR), "min", reverse=True)
    assert torch.equal(last, torch.where(t >= r, r, -FAR).to(torch.int32))
    assert torch.equal(nxt, torch.where(t <= r, r, FAR).to(torch.int32))


def test_plain_version_is_the_detectors_former_code():
    """The CPU route: cumsum, cummin, cummax, the flipped cummin and the
    doubling scan, bit for bit (so every CPU parity test is unchanged)."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.randn(5000, 2) * 1e3).astype(np.float32))
    assert torch.equal(scan.scan_cols(x, "add"), torch.cumsum(x, dim=0))
    assert torch.equal(scan.scan_cols(x, "min"), torch.cummin(x, dim=0).values)
    i = torch.from_numpy(rng.randint(-9, 9, size=5000).astype(np.int32))
    assert torch.equal(scan.scan_cols(i, "max"), torch.cummax(i, dim=0).values)
    flipped = torch.flip(torch.cummin(torch.flip(i, [0]), dim=0).values, [0])
    assert torch.equal(scan.scan_cols(i, "min", reverse=True), flipped)
    assert tvad._affine_scan is scan.affine_scan_plain


def test_cpu_route_launches_nothing_and_other_devices_raise():
    before = scan.launches
    scan.scan_cols(torch.zeros(10), "add")
    scan.affine_scan(torch.ones(10, 6), torch.zeros(10, 6))
    assert scan.launches == before
    meta = torch.empty((10, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        scan.scan_cols(meta, "add")
    with pytest.raises(ValueError, match="unsupported device"):
        scan.affine_scan(meta, meta)
    with pytest.raises(ValueError, match="unknown op"):
        scan.scan_cols(torch.zeros(3), "mul")


def test_band_weights_are_made_once_per_device():
    tvad._band_weights.cache_clear()
    rng = np.random.RandomState(2)
    bands = torch.from_numpy(np.exp(rng.randn(300, 6)).astype(np.float32))
    logmel = torch.from_numpy(rng.randn(300, 40).astype(np.float32))
    st = tvad.initial_state(torch.device("cpu"))
    for _ in range(3):
        tvad._webrtc_from_bands(bands, logmel, 300, st["ema"], st["noise"], st["prev_p"],
                                st["prev_m"], 0, st["prev_ldb"], 0)
    info = tvad._band_weights.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    w = tvad._band_weights(torch.device("cpu"))
    assert w is tvad._band_weights(torch.device("cpu"))
    np.testing.assert_array_equal(w.numpy(), tvad._BAND_WEIGHTS)


def test_host_to_device_on_the_cpu_is_the_array():
    x = np.arange(12, dtype=np.int16).reshape(3, 4)
    t = host_to_device(x, torch.device("cpu"))
    assert t.dtype == torch.int16 and not t.is_pinned()
    np.testing.assert_array_equal(t.numpy(), x)


# ---- the emulated kernel through the detector, against the JAX package ----

def _long_chunk(t=60000):
    """tests/test_torch_webrtc.py::test_long_chunk_label_agreement's input."""
    from tests.test_torch_webrtc import _random_logmel

    rng = np.random.RandomState(123)
    n = np.arange(t)
    gain_db = np.where(
        (n // 3000) % 2 == 0,
        25.0 + 8.0 * np.sin(2 * np.pi * 4.0 * n / 100.0),
        25.0 + 0.3 * np.sin(2 * np.pi * 0.2 * n / 100.0),
    )
    gain_db = np.where(rng.rand(t) < 0.15, -10.0, gain_db)
    bands = (np.exp(rng.randn(t, 6) * 0.3) * 10.0 ** (gain_db / 10.0)[:, None]).astype(
        np.float32
    )
    return bands, _random_logmel(rng, t)


def test_emulated_kernel_through_the_detector_against_jax(monkeypatch):
    """The kernel's order of operations in every scan of
    ``_webrtc_from_bands`` at 60,000 windows, held against the JAX
    package's two-level scans at LABEL_AGREEMENT and STATE_RTOL (the JAX
    side is imported here: the card's machine, which runs this file's
    ``cuda`` cases, has no JAX)."""
    from tests.test_torch_webrtc import (
        LABEL_AGREEMENT, STATE_RTOL, _compare, _fresh_state, _run_port, _run_ref,
    )

    bands, logmel = _long_chunk()
    t = len(bands)
    st = _fresh_state()
    ref = _run_ref(bands, logmel, t, st)
    plain = _run_port(bands, logmel, t, st)
    monkeypatch.setattr(scan, "scan_cols", _emulated_scan_cols)
    monkeypatch.setattr(scan, "affine_scan", _emulated_affine_scan)
    emulated = _run_port(bands, logmel, t, st)
    agree_s, agree_f = _compare(ref, emulated, t)
    plain_s, plain_f = _compare(ref, plain, t)
    print("60k-window label agreement with the JAX package: emulated kernel strength %.6f "
          "fuse %.6f, plain strength %.6f fuse %.6f (bar %g, state rtol %g)"
          % (agree_s, agree_f, plain_s, plain_f, LABEL_AGREEMENT, STATE_RTOL))


# ---- the kernel on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op,dtype,reverse", CASES)
def test_kernel_against_plain_and_emulation(cuda_device, op, dtype, reverse, n):
    """On the card: min and max equal the plain version's; every op equals
    the emulation bit for bit."""
    for c in (1, 2, 6):
        x = torch.from_numpy(_inputs(op, dtype, n, c, seed=n + c))
        got = scan.scan_cols(x.to(cuda_device), op, reverse).cpu()
        assert torch.equal(got, _emulated_scan_cols(x, op, reverse))
        if op != "add":
            assert torch.equal(got, scan.scan_cols_plain(x, op, reverse))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
def test_affine_kernel_against_emulation(cuda_device, n):
    a, b = (torch.from_numpy(t) for t in _affine_inputs(n, 6, seed=n, n_valid=n - n // 3))
    got = scan.affine_scan(a.to(cuda_device), b.to(cuda_device))
    for g, w in zip(got, _emulated_affine_scan(a, b)):
        assert torch.equal(g.cpu(), w)
