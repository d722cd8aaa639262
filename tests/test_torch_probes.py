# -*- coding: utf-8 -*-
"""The port's three EVAL.md probe protocols against the JAX package's
scripts (``scripts/probe_babble_ceiling.py``, ``probe_noisy_jitter.py``,
``probe_webrtc_bias.py``), at a small size on the CPU. The JAX side runs
its VAD programs with Pallas in interpret mode, as the port's other parity
tests do."""
import importlib.util
import inspect
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ffsubsync_tpu.models import neural_vad as jnv
from ffsubsync_tpu.ops import features as jfeat
from ffsubsync_tpu_torch.models import neural_vad as tnv
from ffsubsync_tpu_torch.scripts import probe_babble_ceiling as tbabble
from ffsubsync_tpu_torch.scripts import probe_noisy_jitter as tjitter
from ffsubsync_tpu_torch.scripts import probe_webrtc_bias as tbias

from tests.test_torch_train import LOSS_ABS, LOSS_REL, PARAM_TOL

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
CPU = torch.device("cpu")
ACC_TOL = 0.01  # tests/test_torch_eval.py's window-accuracy bound
# the probe's losses: twice tests/test_torch_train.py's bound. Measured: at
# the JAX init the net puts p < 2e-4 on every speech window of the first
# batch, where log(p + 1e-6) resolves float32 rounding of p; against a
# float64 run of the port (loss 4.471944) the port's float32 loss is 8.5e-5
# above and the JAX script's 8.3e-5 below, 1.7e-4 apart
BABBLE_LOSS_REL = 2 * LOSS_REL
# the parameters after the two steps: within tests/test_torch_train.py's
# PARAM_TOL on BABBLE_PARAM_SHARE of the entries, within twice the summed
# learning rates on all. Measured: 0.9695 within 1e-5; the others 2 lr
# apart, each with a gradient of at most 1.2% of the largest, inside that
# file's gradient bound (10%), where Adam's normalized step may take either
# sign; on synthetic training batches 0.99 of the entries hold
BABBLE_PARAM_SHARE = 0.96
CELL_TOL = 1  # offsets from the truth, in 10 ms cells


def _load(script):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.splitext(script)[0], os.path.join(SCRIPTS, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FFS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FFS_TPU_PALLAS_INTERPRET", "1")


def _jax_main(script, argv, monkeypatch, capsys):
    """One JAX script's ``main`` under ``argv``; its JSON line."""
    mod = _load(script)
    monkeypatch.setattr(sys, "argv", [script] + argv)
    assert mod.main() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_main(module, argv, capsys):
    """One port script's ``main`` (its device ``FFS_TORCH_DEVICE=cpu``);
    its JSON line and standard error."""
    assert module.main(argv) == 0
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured.err


# --------------------------------------------------------------------------
# babble ceiling
# --------------------------------------------------------------------------

def test_probe_batch_is_a_verbatim_copy():
    theirs = inspect.getsource(_load("probe_babble_ceiling.py")._probe_batch)
    ours = inspect.getsource(tbabble._probe_batch)
    assert ours == re.sub(r"\bffsubsync_tpu\b", "ffsubsync_tpu_torch", theirs)


def test_babble_parser_keeps_the_reference_flags():
    args = tbabble.make_parser().parse_args([])
    assert (args.steps, args.batch, args.clip_seconds, args.frame_rate, args.sample_rate,
            args.lr, args.seed) == (900, 8, 10.0, 12000, 100, 1e-3, 0)
    assert (tbabble.SCORE_CLIPS, tbabble.SCORE_SECONDS, tbabble.HELD_OUT_SEED) == (6, 30.0, 10_000)


def _jax_probe_steps(init, args, jprobe):
    """The JAX script's training loop (its loss, schedule, clip and Adam),
    from ``init``: the losses and the parameters after the last step."""
    window = args.frame_rate // args.sample_rate
    mel_fb = jnp.asarray(jfeat.mel_filterbank(window // 2 + 1, args.frame_rate, jnv.N_MELS))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, min(100, max(args.steps // 10, 1)), max(args.steps, 1), args.lr * 0.05)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))

    def loss_fn(params, pcm_batch, label_batch):
        def clip_loss(pcm, labels):
            feats = jfeat.log_mel_features(pcm, mel_fb, window)
            probs = jnv.apply_model(params, feats)[: labels.shape[0]]
            eps = 1e-6
            return jnp.mean(-(labels * jnp.log(probs + eps)
                              + (1 - labels) * jnp.log(1 - probs + eps)))

        return jnp.mean(jax.vmap(clip_loss)(pcm_batch, label_batch))

    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = opt.init(params)
    rng = np.random.RandomState(args.seed)
    losses = []
    for _ in range(args.steps):
        pcm16, labels = jprobe._probe_batch(rng, args.batch, args.clip_seconds,
                                            args.frame_rate, args.sample_rate)
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(pcm16), jnp.asarray(labels))
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def test_babble_training_matches_reference():
    """Two steps at batch 2 x 2 s from the JAX init carried across
    (learning rates 0 and 1e-3): the losses within ``BABBLE_LOSS_REL``, the
    parameters within ``PARAM_TOL`` on ``BABBLE_PARAM_SHARE`` of the
    entries and within twice the summed learning rates on all."""
    args = tbabble.make_parser().parse_args(["--steps", "2", "--batch", "2", "--clip-seconds", "2"])
    init = {k: np.asarray(v) for k, v in jnv.init_params(jax.random.PRNGKey(0)).items()}
    want_losses, want_params = _jax_probe_steps(init, args, _load("probe_babble_ceiling.py"))
    run = tbabble.train(args, CPU, init=init)
    assert len(run.losses) == 2
    np.testing.assert_allclose(run.losses, want_losses, rtol=BABBLE_LOSS_REL, atol=LOSS_ABS)
    lr_sum = sum(float(tbabble.schedule(args, i)) for i in range(2))
    assert lr_sum == pytest.approx(1e-3)
    got = tnv.params_to_numpy(run.net)
    diffs = np.concatenate([np.abs(got[k] - want_params[k]).ravel() for k in want_params])
    assert np.mean(diffs <= PARAM_TOL) >= BABBLE_PARAM_SHARE, np.mean(diffs <= PARAM_TOL)
    assert diffs.max() <= 2 * lr_sum, diffs.max()


def test_babble_scoring_matches_reference():
    """The scoring of one net on one 3-s held-out clip per condition: the
    probe's and the shipped detector's window accuracy within 0.01 of the
    JAX script's scoring of the same clips. The net is the shipped 12 kHz
    one, whose confident outputs leave few windows near the threshold."""
    from ffsubsync_tpu.models.eval_data import condition_clips
    from ffsubsync_tpu.ops.vad import make_detector

    args = tbabble.make_parser().parse_args([])
    with np.load(jnv.default_weights_path(args.frame_rate)) as f:
        params = {k: f[k] for k in f.files}
    net = tnv.NeuralVADNet()
    net.load_state_dict(tnv.params_from_numpy(params))
    got = tbabble.score(net, args, CPU, n_clips=1, clip_seconds=3.0)
    assert sorted(got) == sorted(tbabble.CONDITIONS)

    window = args.frame_rate // args.sample_rate
    mel_fb = jnp.asarray(jfeat.mel_filterbank(window // 2 + 1, args.frame_rate, jnv.N_MELS))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    for cond in tbabble.CONDITIONS:
        clips = condition_clips(cond, 1, 3.0, args.frame_rate, args.sample_rate,
                                seed=args.seed + 10_000)
        hits_p = hits_s = total = 0
        for pcm16, labels, mask in clips:
            n = len(labels)
            feats = jfeat.log_mel_features(jnp.asarray(pcm16), mel_fb, window)
            pp = np.asarray(jnv.apply_model(jparams, feats))[:n] > 0.5
            shipped = make_detector("silero", args.sample_rate, args.frame_rate, 0.0)
            sp = np.asarray(shipped(pcm16.tobytes()))[:n] > 0.5
            want = labels[:n] > 0.5
            hits_p += int(((pp == want) & mask[:n]).sum())
            hits_s += int(((sp == want) & mask[:n]).sum())
            total += int(mask[:n].sum())
        assert total > 0
        for key, hits in (("probe", hits_p), ("shipped", hits_s)):
            assert abs(got[cond][key] - hits / total) <= ACC_TOL, (cond, key, got[cond], hits / total)


# --------------------------------------------------------------------------
# noisy jitter and webrtc bias
# --------------------------------------------------------------------------

def _same_report(got, want, leaf_close):
    """Equal JSON objects, except leaves that ``leaf_close`` accepts."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (got, want)
        for key in want:
            _same_report(got[key], want[key], leaf_close)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (got, want)
        for a, b in zip(got, want):
            _same_report(a, b, leaf_close)
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert leaf_close(got, want), (got, want)
    else:
        assert got == want


def _within_cells(cells):
    def close(got, want):
        return isinstance(got, (int, float)) and abs(got - want) <= cells + 1e-9
    return close


def test_noisy_jitter_probe_matches_reference(monkeypatch, capsys):
    """One seed at 1 minute with the fused VAD: the same JSON line, each
    cell (and the envelope) within one cell of the reference's."""
    argv = ["--seeds", "0", "--lengths", "1", "--vads", "fused"]
    want = _jax_main("probe_noisy_jitter.py", argv, monkeypatch, capsys)
    got, _err = _port_main(tjitter, argv + ["--platform", "cpu"], capsys)
    assert [r["seed"] for r in got["sweep"]] == [0]
    assert got["sweep"][0]["cells"]["fused"] is not None
    _same_report(got, want, _within_cells(CELL_TOL))


def test_webrtc_bias_probe_matches_reference(monkeypatch, capsys, tmp_path):
    """One seed at 1 minute on the music_bed scenario, each in a harness
    process of its own: the same JSON line (and ``--out`` file), the
    error within one 10 ms cell of the reference's."""
    argv = ["--seeds", "1", "--minutes", "1", "--scenarios", "music_bed"]
    want = _jax_main("probe_webrtc_bias.py", argv, monkeypatch, capsys)
    out = tmp_path / "bias.json"
    got, err = _port_main(tbias, argv + ["--out", str(out)], capsys)
    assert json.loads(out.read_text()) == got
    assert list(got["by_minutes"]["1"]["per_seed"]["1"]) == ["music_bed"]
    _same_report(got, want, _within_cells(CELL_TOL * 0.01))
    assert "frontend kernel launches: 0" in err  # the CPU runs no kernel
