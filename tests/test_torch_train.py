# -*- coding: utf-8 -*-
"""Training the neural VAD with the port against the JAX package's trainer.

Both sides start from the same parameters (JAX ``init_params(PRNGKey(0))``
as numpy, loaded into the port with ``params_from_numpy``) and see the same
numpy batches. The JAX side runs as its own tests run it: on the CPU, its
8-device mesh virtual (``tests/conftest.py``)."""
import numpy as np
import pytest
import torch

import jax

from ffsubsync_tpu.models import neural_vad as jnv
from ffsubsync_tpu_torch.models import neural_vad as tnv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")


def _jax_init():
    return {k: np.asarray(v) for k, v in jnv.init_params(jax.random.PRNGKey(0)).items()}


def test_fallback_init_has_the_reference_distribution(monkeypatch, tmp_path):
    """Without usable weights ``load_net`` falls back to a random net drawn
    from the reference's distributions: conv weights of std 1/sqrt(5*96),
    zero biases, and every weight's std that of JAX ``init_params``. The
    sample std of n normal draws has a relative standard error of
    1/sqrt(2n); two independent draws are held within 10% or within three
    standard errors of their difference, whichever is wider (10% for every
    tensor of 1000 or more entries; 31% for the 96 entries of ``w_out``)."""
    monkeypatch.setattr(tnv, "default_weights_path", lambda rate=None: str(tmp_path / "none.npz"))
    net = tnv.load_net(12000, torch.device("cpu"))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    for i in range(len(tnv.DILATIONS)):
        w = sd["convs.%d.weight" % i]
        assert abs(w.std() * np.sqrt(5 * 96) - 1.0) <= 0.10, (i, w.std())
    for name, value in sd.items():
        if name.endswith("bias"):
            assert not value.any(), name
    # the net's tensors in the JAX layout, to compare with init_params
    port = {
        "w_in": sd["inp.weight"].T,
        "w_out": sd["out.weight"].T,
        **{"w_conv%d" % i: sd["convs.%d.weight" % i].transpose(2, 1, 0)
           for i in range(len(tnv.DILATIONS))},
    }
    ref = _jax_init()
    for name, value in port.items():
        assert value.shape == ref[name].shape
        bound = max(0.10, 3.0 * np.sqrt(2.0 / (2.0 * value.size)))
        ratio = value.std() / ref[name].std()
        assert abs(ratio - 1.0) <= bound, (name, value.std(), ref[name].std())


# --------------------------------------------------------------------------
# the JAX side: the reference trainer's pieces, run on the CPU
# --------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from ffsubsync_tpu.ops import features as jfeat  # noqa: E402
from ffsubsync_tpu.parallel import batch as jbatch  # noqa: E402
from ffsubsync_tpu_torch.models.synth_data import synth_batch  # noqa: E402
from ffsubsync_tpu_torch.ops.features import log_mel_features  # noqa: E402
from ffsubsync_tpu_torch.parallel.batch import (  # noqa: E402
    adam, make_vad_train_step, vad_batch_gradients,
)
from ffsubsync_tpu_torch.scripts import train_neural_vad as ttrain  # noqa: E402

CPU = torch.device("cpu")
RATE, SR = 12000, 100
WINDOW = RATE // SR
LR = 3e-3
# one step's loss, relative; each gradient tensor: max |d| <= GRAD_REL *
# max |g_jax| + GRAD_ABS. Measured, not chosen: at init the net's per-clip
# normalization divides log-mel channels that sit near the log floor
# (nearly constant) by their std + 1e-3, so the float32 rounding of their
# mean, which depends on the order of the sum, moves the normalized input
# by up to 3e-3 on either side. Against a float64 run of the port both
# float32 runs are off by as much (gradients 3e-4 to 6e-2 of their largest
# entry, the loss 1e-5); between them the loss differed by up to 3.6e-5
# and the gradients by up to 6.0e-2 (seeds 5-8, both losses).
LOSS_REL, GRAD_REL, GRAD_ABS = 1e-4, 0.1, 1e-7
# parameters after a few Adam steps: within PARAM_TOL on PARAM_SHARE of the
# entries, and within twice the summed learning rates on all of them. Adam
# normalizes each element: its first step moves every entry by +-lr, so an
# entry whose gradient lies within the gradient bound of zero may step
# either way. Measured: 0.9983 of the entries within 1e-5 after the
# 8-device step (one step at 3e-3), the others 2 lr apart; 0.9924 after the
# script's first three steps (learning rates 0, 5e-5, 1e-4), the others at
# most 2.6e-4 apart.
PARAM_TOL, PARAM_SHARE = 1e-5, 0.99
# a loss near 0 (every window confidently right) is a sum of float32 logs
# of numbers near 1, resolved to about 1e-7 each
LOSS_ABS = 1e-6


def _batch(seed, n, seconds=2.0, rate=RATE, weights=False):
    return synth_batch(np.random.RandomState(seed), n, seconds, rate, SR,
                       return_weights=weights)


def _mel_fb(rate):
    window = rate // SR
    return jnp.asarray(jfeat.mel_filterbank(window // 2 + 1, rate, 40))


def _port_net(params):
    net = tnv.NeuralVADNet()
    net.load_state_dict(tnv.params_from_numpy(params))
    return net.train()


def _grads(net):
    return tnv.jax_layout({n: p.grad for n, p in net.named_parameters()})


def _jax_loss(weighted):
    """The reference's loss: ``ffsubsync_tpu/parallel/batch.py``'s (mean
    over clips) or ``scripts/train_neural_vad.py``'s (weighted mean)."""
    mel_fb = _mel_fb(RATE)

    def loss_fn(params, pcm_batch, label_batch, weight_batch):
        def clip_loss(pcm, labels):
            feats = jfeat.log_mel_features(pcm, mel_fb, WINDOW)
            probs = jnv.apply_model(params, feats)[: labels.shape[0]]
            eps = 1e-6
            return jnp.mean(-(labels * jnp.log(probs + eps)
                              + (1 - labels) * jnp.log(1 - probs + eps)))

        per_clip = jax.vmap(clip_loss)(pcm_batch, label_batch)
        if weighted:
            return jnp.sum(per_clip * weight_batch) / jnp.sum(weight_batch)
        return jnp.mean(per_clip)

    return loss_fn


def _jax_script_optimizer(steps):
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=LR, warmup_steps=min(100, max(steps // 10, 1)),
        decay_steps=max(steps, 1), end_value=LR * 0.05,
    )
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))


def _assert_grads_close(got, want):
    for name in want:
        bound = GRAD_REL * float(np.abs(want[name]).max()) + GRAD_ABS
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= bound, (name, err, bound)


def _assert_params_close(got, want, lr_sum):
    diffs = np.concatenate([np.abs(got[k] - np.asarray(want[k])).ravel() for k in want])
    assert np.mean(diffs <= PARAM_TOL) >= PARAM_SHARE, np.sort(diffs)[-20:]
    assert diffs.max() <= 2 * lr_sum, diffs.max()


@pytest.fixture(scope="module")
def init():
    return _jax_init()


# --------------------------------------------------------------------------
# features and the forward pass
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [12000, 48000, 1600])
def test_log_mel_features_match_reference(rate):
    """The trainer's feature pass (the frontend's plain version on the CPU)
    against ``ffsubsync_tpu``'s ``log_mel_features`` on each clip, at
    windows of 120, 480 and 16 samples, under the frontend tests' own
    tolerance."""
    pcm, _labels = _batch(1, 3, 1.0 if rate == 48000 else 2.0, rate)
    got = log_mel_features(pcm, rate, SR, CPU).numpy()
    window = rate // SR
    assert got.shape == (3, pcm.shape[1] // window, 40)
    for clip, feats in zip(pcm, got):
        want = np.asarray(jfeat.log_mel_features(jnp.asarray(clip), _mel_fb(rate), window))
        np.testing.assert_allclose(feats, want, rtol=2e-3, atol=2e-3)


def test_log_mel_features_drops_a_partial_window():
    pcm = np.random.RandomState(2).randint(-3000, 3000, (2, 10 * WINDOW + 37)).astype(np.int16)
    assert log_mel_features(pcm, RATE, SR, CPU).shape == (2, 10, 40)
    with pytest.raises(ValueError, match="int16"):
        log_mel_features(pcm.astype(np.float32), RATE, SR, CPU)


def test_apply_model_matches_reference(init):
    """Batched ``apply_model`` against the reference's per clip (|dp| <=
    1e-4); the batched forward against one call per clip (measured 1.5e-7
    apart: the convolutions' batched algorithm sums in another order)."""
    pcm, _labels = _batch(3, 3)
    feats = log_mel_features(pcm, RATE, SR, CPU)
    net = _port_net(init)
    with torch.no_grad():
        got = tnv.apply_model(net, feats).numpy()
        singles = [tnv.apply_model(net, f).numpy() for f in feats]
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    for clip, probs, single in zip(feats.numpy(), got, singles):
        want = np.asarray(jnv.apply_model(jparams, jnp.asarray(clip)))
        np.testing.assert_allclose(probs, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(probs, single, atol=1e-6, rtol=0)


def test_apply_model_normalizes_with_the_population_std(init):
    """``jnp.std`` divides by T, ``torch.std`` by T - 1 unless told."""
    feats = torch.from_numpy(np.random.RandomState(4).randn(50, 40).astype(np.float32))
    net = _port_net(init)
    mean = feats.mean(0, keepdim=True)
    std = torch.from_numpy(np.std(feats.numpy(), axis=0, keepdims=True)) + 1e-3
    with torch.no_grad():
        want = net((feats - mean) / std, torch.ones(50))
        assert torch.allclose(tnv.apply_model(net, feats), want, atol=1e-7, rtol=0)


# --------------------------------------------------------------------------
# one step: loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True], ids=["mesh_step", "script_step"])
def test_loss_and_gradients_match_reference(init, weighted):
    """The loss and every gradient of one batch against
    ``jax.value_and_grad`` of the reference's loss: the mesh step's mean
    over clips, and the training script's weighted mean."""
    pcm, labels, weights = _batch(5, 4, weights=True)
    assert weights.min() != weights.max()  # the weights matter
    loss, grads = jax.value_and_grad(_jax_loss(weighted))(
        {k: jnp.asarray(v) for k, v in init.items()}, jnp.asarray(pcm),
        jnp.asarray(labels), jnp.asarray(weights))
    net = _port_net(init)
    got = vad_batch_gradients(net, (CPU,), {}, pcm, labels, WINDOW, SR,
                              weights if weighted else None)
    assert float(got) == pytest.approx(float(loss), rel=LOSS_REL)
    _assert_grads_close(_grads(net), {k: np.asarray(v) for k, v in grads.items()})


# --------------------------------------------------------------------------
# the script's optimizer against optax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3, 600, 1800])
def test_schedule_matches_optax(steps):
    args = ttrain.make_parser().parse_args(["--steps", str(steps)])
    if steps == 1:
        # one step leaves the cosine phase no step: optax refuses it
        with pytest.raises(ValueError):
            _jax_script_optimizer(steps)
        with pytest.raises(ValueError):
            ttrain.schedule(args, 0)
        return
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=LR, warmup_steps=min(100, max(steps // 10, 1)),
        decay_steps=max(steps, 1), end_value=LR * 0.05)
    counts = range(steps + 6)
    got = np.array([ttrain.schedule(args, c) for c in counts])
    ref = np.array([float(want(c)) for c in counts])
    assert got[0] == 0.0
    # optax evaluates in float32 (1.7e-6 relative off the exact value at
    # worst, measured); the port's schedule in float64
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_matches_optax(norm):
    rng = np.random.RandomState(6)
    grads = [rng.randn(*s).astype(np.float32) for s in ((43, 96), (96,), (5, 96, 96))]
    scale = norm / np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    grads = [g * np.float32(scale) for g in grads]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    ttrain.clip_by_global_norm(got, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if norm < 1.0:
        assert all(np.array_equal(g.numpy(), h) for g, h in zip(got, grads))


@pytest.fixture(scope="module")
def three_steps(init):
    """The first three steps of the script's optimizer at its default
    schedule (``--steps 600``: learning rates 0, 5e-5 and 1e-4) on both
    sides from the same init and batches: per side the losses, the
    parameters after step 0 and after step 2, and Adam's moments after
    step 0."""
    batches = [_batch(10 + i, 2, weights=True) for i in range(3)]
    loss_fn = _jax_loss(weighted=True)
    opt = _jax_script_optimizer(600)

    @jax.jit
    def step(params, opt_state, pcm, labels, weights):
        loss, grads = jax.value_and_grad(loss_fn)(params, pcm, labels, weights)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = opt.init(params)
    jax_side = {"losses": []}
    for i, (pcm, labels, weights) in enumerate(batches):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(pcm),
                                       jnp.asarray(labels), jnp.asarray(weights))
        jax_side["losses"].append(float(loss))
        if i == 0:
            adam_state = opt_state[1][0]
            jax_side["step0"] = {k: np.asarray(v) for k, v in params.items()}
            jax_side["mu"] = {k: np.asarray(v) for k, v in adam_state.mu.items()}
            jax_side["nu"] = {k: np.asarray(v) for k, v in adam_state.nu.items()}
    jax_side["final"] = {k: np.asarray(v) for k, v in params.items()}

    args = ttrain.make_parser().parse_args([])
    net = _port_net(init)
    optimizer = adam(net, 0.0)
    port = {"losses": [], "lrs": []}
    for i, (pcm, labels, weights) in enumerate(batches):
        port["lrs"].append(ttrain.schedule(args, i))
        loss = ttrain.train_step(net, optimizer, port["lrs"][-1], pcm, labels, weights,
                                 WINDOW, SR)
        port["losses"].append(float(loss))
        if i == 0:
            port["step0"] = tnv.params_to_numpy(net)
            for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                port[key] = tnv.jax_layout({n: optimizer.state[p][moment]
                                            for n, p in net.named_parameters()})
    port["final"] = tnv.params_to_numpy(net)
    return jax_side, port


def test_first_step_leaves_parameters_at_init(init, three_steps):
    """optax's first update runs at ``schedule(0) = 0``: the parameters stay
    bitwise at init while Adam's moments move."""
    jax_side, port = three_steps
    assert port["lrs"][0] == 0.0
    for k in init:
        assert np.array_equal(port["step0"][k], init[k]), k
        assert np.array_equal(jax_side["step0"][k], init[k]), k
    assert any(np.abs(v).max() > 0 for v in port["mu"].values())


def test_adam_moments_match_optax(three_steps):
    """After one step, Adam's ``exp_avg`` / ``exp_avg_sq`` against optax's
    ``mu`` / ``nu``: mu = 0.1 g within the gradient bound, nu = 0.001 g^2
    within twice it (a square doubles the relative error)."""
    jax_side, port = three_steps
    _assert_grads_close(port["mu"], jax_side["mu"])
    for name, want in jax_side["nu"].items():
        bound = 2 * GRAD_REL * float(np.abs(want).max()) + GRAD_ABS ** 2
        assert float(np.abs(port["nu"][name] - want).max()) <= bound, name


def test_three_steps_match_reference(three_steps):
    jax_side, port = three_steps
    np.testing.assert_allclose(port["losses"], jax_side["losses"], rtol=LOSS_REL, atol=LOSS_ABS)
    _assert_params_close(port["final"], jax_side["final"], sum(port["lrs"]))


# --------------------------------------------------------------------------
# the data-parallel step over a mesh
# --------------------------------------------------------------------------

def _port_mesh_step(mesh, init, pcm, labels):
    step_fn, init_fn = make_vad_train_step(mesh, learning_rate=LR)
    net, optimizer, window = init_fn(torch.Generator().manual_seed(0), frame_rate=RATE)
    assert window == WINDOW and next(net.parameters()).device == mesh[0]
    net.load_state_dict(tnv.params_from_numpy(init))
    loss = step_fn(net, optimizer, pcm, labels, window)
    return float(loss), tnv.params_to_numpy(net)


def test_mesh_step_matches_reference_mesh(init):
    """The port's step over 8 CPU "devices" against the reference's
    ``make_vad_train_step`` over its 8-device mesh, batch 8: the loss, and
    the parameters after one Adam step at 3e-3."""
    pcm, labels = _batch(20, 8)
    devices = np.array(jax.devices()[:8])
    assert devices.size == 8
    mesh = Mesh(devices, ("data",))
    step_fn, init_fn = jbatch.make_vad_train_step(mesh, learning_rate=LR)
    params, opt_state, mel_fb, window = init_fn(jax.random.PRNGKey(0), frame_rate=RATE)
    for k in init:  # the same init on both sides
        assert np.array_equal(np.asarray(params[k]), init[k])
    data = NamedSharding(mesh, P("data"))
    params, opt_state, loss = step_fn(
        params, opt_state, mel_fb, jax.device_put(pcm, data), jax.device_put(labels, data),
        window)
    got_loss, got = _port_mesh_step((CPU,) * 8, init, pcm, labels)
    assert got_loss == pytest.approx(float(loss), rel=LOSS_REL)
    _assert_params_close(got, params, LR)


def test_ragged_mesh_step_equals_one_device(init, monkeypatch):
    """8 clips over 3 devices (groups of 3, 3 and 2, each one feature pass)
    against one device: each group's gradients are weighed by its size."""
    import ffsubsync_tpu_torch.parallel.batch as tbatch

    pcm, labels = _batch(21, 8)
    seen = []
    real = tbatch.log_mel_features
    monkeypatch.setattr(tbatch, "log_mel_features",
                        lambda p, *a: seen.append(p.shape[0]) or real(p, *a))
    one_loss, one = _port_mesh_step((CPU,), init, pcm, labels)
    assert seen == [8]
    seen.clear()
    loss, got = _port_mesh_step((CPU,) * 3, init, pcm, labels)
    assert seen == [3, 3, 2]
    assert loss == pytest.approx(one_loss, rel=LOSS_REL)
    _assert_params_close(got, one, LR)


def test_mesh_step_refreshes_replicas_between_steps(init):
    """Two steps over 2 devices equal two steps on one: the second slot's
    replica reads the parameters the first step wrote."""
    batches = [_batch(22 + i, 4) for i in range(2)]
    finals = []
    for mesh in ((CPU,), (CPU, CPU)):
        step_fn, init_fn = make_vad_train_step(mesh, learning_rate=LR)
        net, optimizer, window = init_fn(torch.Generator().manual_seed(0), frame_rate=RATE)
        net.load_state_dict(tnv.params_from_numpy(init))
        losses = [float(step_fn(net, optimizer, pcm, labels, window)) for pcm, labels in batches]
        finals.append((losses, tnv.params_to_numpy(net)))
    np.testing.assert_allclose(finals[1][0], finals[0][0], rtol=LOSS_REL)
    _assert_params_close(finals[1][1], finals[0][1], 2 * LR)


def test_graft_entry_shapes(init):
    """The reference graft entry's step: 1600 Hz, 16-sample windows, 4-s
    clips of random PCM and labels, 2 clips per device of 8."""
    rng = np.random.RandomState(7)
    pcm = rng.randint(-3000, 3000, size=(16, 4 * 1600)).astype(np.int16)
    labels = (rng.rand(16, 400) > 0.5).astype(np.float32)
    step_fn, init_fn = make_vad_train_step((CPU,) * 8)
    net, optimizer, window = init_fn(torch.Generator().manual_seed(0), frame_rate=1600)
    assert window == 16
    assert np.isfinite(float(step_fn(net, optimizer, pcm, labels, window)))


# --------------------------------------------------------------------------
# the weights file
# --------------------------------------------------------------------------

def test_params_round_trip_the_shipped_file():
    with np.load(tnv.default_weights_path(12000)) as f:
        shipped = {k: f[k] for k in f.files}
    got = tnv.params_to_numpy(_port_net(shipped))
    assert sorted(got) == sorted(shipped)
    for k, v in shipped.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_cli_writes_weights_both_packages_read(tmp_path, capsys):
    out = tmp_path / "w.npz"
    assert ttrain.main(["--steps", "2", "--batch", "2", "--clip-seconds", "2",
                        "--frame-rate", "12000", "--out", str(out), "--platform", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "held-out window accuracy" in printed and "step    1" in printed
    with np.load(out) as f:
        written = {k: f[k] for k in f.files}
    assert {k: v.shape for k, v in written.items()} == tnv.expected_param_shapes()
    assert {k: v.shape for k, v in written.items()} == jnv.expected_param_shapes()
    assert all(v.dtype == np.float32 for v in written.values())
    feats = (np.random.RandomState(8).randn(512, 40) * 3.0 - 5.0).astype(np.float32)
    want = np.asarray(jnv._probs_from_feats(
        {k: jnp.asarray(v) for k, v in written.items()}, jnp.asarray(feats), jnp.int32(450)))
    got = tnv.probs_from_feats(_port_net(written).eval(), torch.from_numpy(feats), 450).numpy()
    np.testing.assert_allclose(got[:450], want[:450], atol=1e-4, rtol=0)
