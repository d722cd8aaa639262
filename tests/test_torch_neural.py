# -*- coding: utf-8 -*-
"""``NeuralVADNet`` (via ``params_from_numpy``) against the JAX package's
``_net`` / ``_probs_from_feats``, with random numpy parameters and with the
shipped 12 kHz weights; the aux channels and box means on their own."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffsubsync_tpu.models import neural_vad as jnv
from ffsubsync_tpu_torch.models import neural_vad as tnv

torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _random_params(seed):
    rng = np.random.RandomState(seed)
    return {
        k: (rng.randn(*shape) / np.sqrt(shape[-2] if len(shape) > 1 else 4)).astype(
            np.float32
        )
        for k, shape in tnv.expected_param_shapes().items()
    }


def _shipped_params():
    with np.load(tnv.default_weights_path(12000)) as f:
        return {k: f[k] for k in f.files}


def _net(params):
    net = tnv.NeuralVADNet()
    net.load_state_dict(tnv.params_from_numpy(params))
    return net.eval()


def _inputs(seed, t, lo, hi):
    """Normalized-looking feats, zeroed outside the valid run [lo, hi)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, 40).astype(np.float32)
    x[:, :8] += np.sin(np.arange(t) / 7.0)[:, None].astype(np.float32)
    vm = np.zeros(t, np.float32)
    vm[lo:hi] = 1.0
    return x * vm[:, None], vm


@pytest.mark.parametrize("weights", ["random", "shipped_12k"])
@pytest.mark.parametrize("valid", [(0, 700), (150, 600)])
def test_net_matches_reference(weights, valid):
    params = _random_params(3) if weights == "random" else _shipped_params()
    x, vm = _inputs(1, 700, *valid)
    want = np.asarray(
        jnv._net({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(vm))
    )
    with torch.no_grad():
        got = _net(params)(torch.from_numpy(x), torch.from_numpy(vm)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_probs_from_feats_matches_reference_with_padding():
    params = _shipped_params()
    rng = np.random.RandomState(4)
    feats = (rng.randn(1024, 40) * 3.0 - 5.0).astype(np.float32)
    n_valid = 900
    want = np.asarray(
        jnv._probs_from_feats(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats), jnp.int32(n_valid)
        )
    )
    got = tnv.probs_from_feats(_net(params), torch.from_numpy(feats), n_valid).numpy()
    np.testing.assert_allclose(got[:n_valid], want[:n_valid], atol=ATOL)


@pytest.mark.parametrize("k, nonneg", [(15, False), (30, True)])
def test_box_mean_matches_reference(k, nonneg):
    rng = np.random.RandomState(k)
    v = np.abs(rng.randn(500)).astype(np.float32)
    vm = np.ones(500, np.float32)
    vm[:40] = 0.0
    want = np.asarray(jnv._box_mean(jnp.asarray(v), jnp.asarray(vm), k, nonneg=nonneg))
    got = tnv._box_mean(torch.from_numpy(v), torch.from_numpy(vm), k, nonneg=nonneg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_box_mean_nonneg_clamps_rounding_below_zero():
    """A near-zero stretch after a large prefix: the clamp keeps the box sum
    of a non-negative series from going negative (NaN under sqrt)."""
    v = torch.cat([torch.full((1000,), 1e4), torch.full((200,), 1e-6)])
    vm = torch.ones_like(v)
    out = tnv._box_mean(v, vm, 30, nonneg=True)
    assert (out >= 0).all()
    assert torch.isfinite(torch.sqrt(out + 1e-6)).all()


def test_aux_channels_match_reference():
    x, vm = _inputs(6, 400, 50, 380)
    want = np.asarray(jnv._aux_channels(jnp.asarray(x), jnp.asarray(vm)))
    got = tnv._aux_channels(torch.from_numpy(x), torch.from_numpy(vm)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_params_from_numpy_layout():
    params = _random_params(0)
    sd = tnv.params_from_numpy(params)
    np.testing.assert_array_equal(sd["inp.weight"].numpy(), params["w_in"].T)
    np.testing.assert_array_equal(sd["out.weight"].numpy(), params["w_out"].T)
    for i, d in enumerate(tnv.DILATIONS):
        w = params["w_conv%d" % i]
        np.testing.assert_array_equal(sd["convs.%d.weight" % i].numpy(), w.transpose(2, 1, 0))
        conv = _net(params).convs[i]
        assert conv.dilation == (d,) and conv.padding == (2 * d,)


def test_load_net_reads_shipped_weights():
    net = tnv.load_net(12000, torch.device("cpu"))
    params = _shipped_params()
    np.testing.assert_array_equal(net.inp.weight.detach().numpy(), params["w_in"].T)
    assert not net.training
