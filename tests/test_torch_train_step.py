"""The training path as a whole, port vs JAX: three optimization steps from
identical weights and batches through ``sdfa_tpu.train.trainer.
make_train_step`` (its scan path on CPU) and through the port's
``Experiment.train_step``, at narrow widths with BatchNorm in batch-statistics
mode and dropout 0 (the two frameworks' random streams cannot match). Then
the port's own runtime: resume ≡ uninterrupted with dropout on, checkpoints,
hooks, validation, and the float32 switches.

Tolerances: loss terms 1e-5 relative at every step, parameters after step 3
1e-5 absolute, scaler states 1e-6 — f32 on both sides, sums in another order.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import _perturb

from sdfa_tpu.models import losses as JL
from sdfa_tpu.models.sdfa import SpeechDrivenAnimation as JModel
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.compat import flax_variables_from_model, load_flax_variables
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.train import Experiment, Trainer, checkpoints
from sdfa_tpu_torch.train.trainer import SCALER_NAMES

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

BN = "batch_norm={'momentum': 0.01, 'eps': 0.001}"
LRELU = "act=lrelu@a:0.2"
N_TRIS, KS, KR = 10, 5, 4


def _specs(lstm_dropout):
    enc = [
        ("permute", (0, 3, 2, 1)),
        ("conv2d", 3, 4, (3, 1), (1, 1), LRELU, BN),
        ("pool2d", "max", (2, 1)),
        ("conv2d", 4, 6, (1, 1), (1, 1), LRELU, BN),
        ("freq-lstm", 6, 8, "hidden_size=8", "output_size=12"),
        ("squeeze", 2),
        ("permute", (0, 2, 1)),
        ("lstm", 12, 8, "num_layers=2", "bidirectional=True", f"dropout={lstm_dropout}"),
        ("attn", "bah", 16, 8, 2, "scale_score_at_eval=2.0"),
    ]
    trunk = [("fc", 16 + 2, 8, LRELU, "cat_condition=2")]
    head_s = [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"), ("fc", 8, KS, "act=linear")]
    head_r = [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"), ("fc", 8, KR, "act=linear")]
    return enc, trunk, head_s, head_r


def _pca(seed=99):
    rng = np.random.default_rng(seed)
    return {"scale": (rng.normal(0, 0.1, (6 * N_TRIS, KS)).astype(np.float32),
                      rng.normal(0, 0.01, (6 * N_TRIS,)).astype(np.float32)),
            "rotat": (rng.normal(0, 0.1, (3 * N_TRIS, KR)).astype(np.float32),
                      rng.normal(0, 0.01, (3 * N_TRIS,)).astype(np.float32))}


def _torch_model(lstm_dropout=0.0):
    enc, trunk, head_s, head_r = _specs(lstm_dropout)
    model = TModel(enc, trunk, head_s, head_r, 6 * N_TRIS, 3 * N_TRIS, KS, KR,
                   weight_norm=True, num_speakers=2)
    with torch.no_grad():
        for name, (comp, means) in _pca().items():
            sub = getattr(model, f"{name}_pca")
            sub.compT.copy_(torch.from_numpy(comp))
            sub.means.copy_(torch.from_numpy(means))
    return model


def _jax_model():
    enc, trunk, head_s, head_r = _specs(0.0)
    pca = _pca()
    return JModel(encoder_specs=freeze_specs(enc), output_specs=freeze_specs(trunk),
                  output_scale_specs=freeze_specs(head_s),
                  output_rotat_specs=freeze_specs(head_r), face_type="dgrad_3d",
                  pred_type="face_data", using_pca=True, weight_norm=True, num_speakers=2,
                  output_dim_scale=6 * N_TRIS, output_dim_rotat=3 * N_TRIS,
                  pca_coeffs_scale=KS, pca_coeffs_rotat=KR,
                  pca_scale_init=lambda: pca["scale"], pca_rotat_init=lambda: pca["rotat"])


def _hparams(optim=None, trainer=None):
    return dict(
        audio=dict(feature=dict(sliding_window_frames=8, with_delta=True),
                   mel=dict(n_mels=16), sample_rate=8000),
        loss=dict(ploss_scale=1, mloss_scale=2, eloss_scale=1, dynamic_scalar=True,
                  anime_loss_weight=None),
        optim=optim or dict(name="Adam", args=dict(lr=1e-3, weight_decay=0),
                            lr_scheduler=None),
        trainer={**dict(max_epochs=1, save_gap_epochs=1, valid_gap_epochs=0,
                        reference_metric="ploss", reference_metric_larger=False),
                 **(trainer or {})},
        model=dict(face_data_type="dgrad_3d", prediction_type="face_data"),
    )


def _batch(seed, coef, bsz=8):
    """First half frame i, second half frame i + 1, as the loader ships them."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 2, (bsz // 2,)).astype(np.int32)
    batch = {"audio_feat": rng.normal(0.4, 0.3, (bsz, 8, 16, 3)).astype(np.float32),
             "speaker_id": np.concatenate([half, half])}
    if coef:
        batch["dgrad_3d_scale_coef"] = rng.normal(0, 1, (bsz, 1, KS)).astype(np.float32)
        batch["dgrad_3d_rotat_coef"] = rng.normal(0, 1, (bsz, 1, KR)).astype(np.float32)
    else:
        batch["dgrad_3d_scale"] = rng.normal(0, 0.1, (bsz, 1, N_TRIS, 6)).astype(np.float32)
        batch["dgrad_3d_rotat"] = rng.normal(0, 0.1, (bsz, 1, N_TRIS, 3)).astype(np.float32)
    return batch


ADAMW_NOAM_CLIP = dict(
    optim=dict(name="AdamW", args=dict(lr=2e-3, weight_decay=0.05),
               lr_scheduler=dict(name="NoamDecay", args=dict(mode="step", warmup_iters=2))),
    trainer=dict(grad_clip=0.5))


@pytest.mark.parametrize("coef,extra", [(False, {}), (True, {}), (True, ADAMW_NOAM_CLIP)],
                         ids=["full-targets-adam", "coef-targets-adam",
                              "coef-targets-adamw-noam-clip"])
def test_three_train_steps_match_jax(tmp_path, coef, extra):
    hp = _hparams(**extra)
    jhp, jmodel = JConfig(hp), _jax_model()
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((2, 8, 16, 3)), jnp.zeros((2,), jnp.int32),
        False))
    variables = _perturb(variables, np.random.default_rng(7))

    tx, lr_fn, beta1_fn, mode, _ = jtrainer.make_optimizer(jhp)
    state = jtrainer.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        constants=variables["constants"], opt_state=tx.init(variables["params"]),
        scalers={n: JL.ScalerState.init() for n in SCALER_NAMES},
        step=jnp.zeros((), jnp.int32))
    step_fn = jtrainer.make_train_step(jmodel, jhp, tx, donate=False)

    exp = Experiment(TConfig(hp), _torch_model(), str(tmp_path), "cpu")
    load_flax_variables(exp.model, variables)
    assert exp.sched_mode == mode

    for step in range(3):
        batch = _batch(10 + step, coef)
        it = step + 1 if mode == "step" else 0
        lr = float(lr_fn(jnp.asarray(it)))
        b1 = float(beta1_fn(jnp.asarray(it))) if beta1_fn else 0.9
        state, want = step_fn(state, {k2: jnp.asarray(v) for k2, v in batch.items()},
                              jax.random.PRNGKey(step), jnp.asarray(lr), jnp.asarray(b1))
        got = exp.train_step(batch)
        assert sorted(got) == sorted(want)
        assert got["lr"] == pytest.approx(lr, rel=1e-6)
        for key, val in want.items():
            assert float(got[key]) == pytest.approx(float(val), rel=1e-5, abs=1e-9), (step, key)

    want_vars = jax.device_get({"params": state.params, "batch_stats": state.batch_stats,
                                "constants": state.constants})
    got_sd = exp.model.state_dict()
    from sdfa_tpu_torch.compat import state_dict_from_flax
    want_sd = state_dict_from_flax(want_vars)
    assert sorted(want_sd) == sorted(got_sd)
    worst = max((float((got_sd[key] - want_sd[key]).abs().max()), key) for key in want_sd)
    assert worst[0] < 1e-5, worst
    for name in SCALER_NAMES:
        for got_v, want_v in zip(exp.scalers[name], state.scalers[name]):
            assert float(got_v) == pytest.approx(float(want_v), abs=1e-6)
    assert exp.step == int(state.step) == 3


def test_state_bridges_back_to_flax_trees(tmp_path):
    """state_dict → flax collections → state_dict is the identity, with
    BatchNorm statistics and the PCA constants in their own collections."""
    exp = Experiment(TConfig(_hparams()), _torch_model(), str(tmp_path), "cpu")
    tree = flax_variables_from_model(exp.model)
    assert sorted(tree) == ["batch_stats", "constants", "params"]
    assert sorted(tree["constants"]) == ["rotat_pca", "scale_pca"]
    assert sorted(tree["batch_stats"]["audio_encoder"]["built_layers_1"]["post_bn"]) == [
        "mean", "var"]
    again = load_flax_variables(_torch_model(), tree).state_dict()
    for key, val in exp.model.state_dict().items():
        assert torch.equal(again[key], val), key
    n_params = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree["params"]))
    assert n_params == sum(p.numel() for p in exp.model.parameters())


def _run(tmp, name, batches, load_from=None, max_epochs=1):
    hp = TConfig(_hparams(trainer=dict(max_epochs=max_epochs)))
    exp = Experiment(hp, _torch_model(lstm_dropout=0.3), str(tmp / name), "cpu",
                     load_from=load_from, seed=5)
    trainer = Trainer(exp, batches)
    trainer.train()
    return exp, trainer


def test_resume_equals_uninterrupted_with_dropout(tmp_path):
    """Dropout masks depend on (seed, global step) only: 2 + 2 steps across a
    checkpoint equal 4 steps in one run, bit for bit."""
    batches = [_batch(20 + i, coef=True) for i in range(4)]
    # uninterrupted: two epochs of two steps
    whole, _ = _run(tmp_path, "whole", batches[:2], max_epochs=1)
    whole.hp.trainer.set_key("max_epochs", 2)
    Trainer(whole, batches[2:]).train()
    # interrupted after epoch 1, resumed in a fresh Experiment
    first, _ = _run(tmp_path, "first", batches[:2], max_epochs=1)
    ckpt = checkpoints.latest_checkpoint(str(tmp_path / "first"))
    assert ckpt is not None
    second, trainer = _run(tmp_path, "second", batches[2:], load_from=ckpt, max_epochs=2)
    assert (second.step, second.epoch) == (whole.step, whole.epoch) == (4, 2)
    for key, val in whole.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[key], val), key
    for name in SCALER_NAMES:
        assert torch.equal(second.scalers[name].vt, whole.scalers[name].vt)
    # dropout was live: a different seed takes another path
    other = Experiment(TConfig(_hparams()), _torch_model(lstm_dropout=0.3),
                       str(tmp_path / "other"), "cpu", seed=6)
    load_flax_variables(other.model, flax_variables_from_model(first.model))
    a = float(other.train_step(batches[2])["total"])
    assert a != pytest.approx(trainer.step_metrics[0]["total"], rel=1e-7)


def test_resume_keeps_loss_history(tmp_path):
    batches = [_batch(30, coef=False)]
    first, _ = _run(tmp_path, "run", batches)
    hp = TConfig(_hparams())
    hp.trainer.set_key("max_epochs", 2)
    exp = Experiment(hp, _torch_model(lstm_dropout=0.3), str(tmp_path / "run"), "cpu",
                     load_from=str(tmp_path / "run" / "last.ckpt"), seed=5)
    Trainer(exp, batches).train()
    rows = open(tmp_path / "run" / "train_log" / "loss" / "epoch-loss.csv").read().splitlines()
    assert [r.split(",")[0] for r in rows] == ["epoch", "0", "1"]


def test_checkpoint_round_trip_prune_and_best(tmp_path):
    exp, _ = _run(tmp_path, "run", [_batch(40, coef=True)])
    run = str(tmp_path / "run")
    payload = exp.payload()
    back = checkpoints.load_checkpoint(os.path.join(run, "last.ckpt"))
    assert (back["epoch"], back["global_step"]) == (1, 1)
    for key, val in payload["model"].items():
        assert torch.equal(back["model"][key], val), key
    for idx, slot in payload["optimizer"]["state"].items():
        for key, val in slot.items():
            assert torch.equal(back["optimizer"]["state"][idx][key], val)
    for name in SCALER_NAMES:
        assert torch.equal(back["scalers"][name][0], payload["scalers"][name][0])
    for step in range(2, 6):
        checkpoints.save_checkpoint(run, payload, 1, step, max_nb=3)
    kept = sorted(f for f in os.listdir(run) if f.startswith("epoch"))
    assert kept == [f"epoch0001-step{n:06d}.ckpt" for n in (3, 4, 5)]
    exp.save_best("ploss", 0.25)
    info = json.load(open(os.path.join(run, "best-ploss.ckpt.info")))
    assert info == {"metric": "ploss", "value": 0.25, "epoch": 1, "step": 1}
    assert checkpoints.latest_checkpoint(str(tmp_path / "none")) is None


def test_run_directory_validation_and_hooks(tmp_path):
    calls = []

    @Trainer.register_hook("prev_epoch")
    def on_prev_epoch(exp, **kw):
        calls.append(("prev_epoch", kw.get("epoch")))

    @Trainer.register_hook("post_valid")
    def on_post_valid(exp, **kw):
        calls.append(("post_valid", kw.get("epoch")))

    try:
        hp = TConfig(_hparams(trainer=dict(valid_gap_epochs=1)))
        exp = Experiment(hp, _torch_model(), str(tmp_path / "run"), "cpu")
        before = {k: v.clone() for k, v in exp.model.state_dict().items()}
        trainer = Trainer(exp, [_batch(50, True), _batch(51, True)],
                          valid_loader=[_batch(52, True)])
        trainer.train()
    finally:
        Trainer._hooks["prev_epoch"].remove(on_prev_epoch)
        Trainer._hooks["post_valid"].remove(on_post_valid)
    assert calls == [("prev_epoch", 0), ("post_valid", 0)]
    run = tmp_path / "run"
    assert json.load(open(run / "hparams.json"))["optim"]["name"] == "Adam"
    info = open(run / "params_info.txt").read().splitlines()
    assert info[-1] == f"TOTAL: {sum(p.numel() for p in exp.model.parameters())}"
    assert any(line.startswith("audio_encoder/built_layers_7/w_hh_l1_reverse") for line in info)
    valid = [json.loads(line) for line in open(run / "train_log" / "metrics.jsonl")]
    assert valid[-1]["tag"] == "valid" and np.isfinite(valid[-1]["scalar_ploss"])
    assert os.path.exists(run / "best-ploss.ckpt")
    assert trainer.best_metric == pytest.approx(valid[-1]["scalar_ploss"])
    assert len(trainer.step_metrics) == 2
    assert all(np.isfinite(v) for m in trainer.step_metrics for v in m.values())
    # validation ran in eval mode: it moved no BatchNorm statistic after training
    assert not exp.model.training
    changed = [k for k, v in exp.model.state_dict().items() if not torch.equal(v, before[k])]
    assert any(k.endswith("post_bn.mean") for k in changed)
    assert not any(k.endswith("compT") for k in changed)
    with pytest.raises(ValueError):
        Trainer(Experiment(TConfig(_hparams(trainer=dict(save_gap_steps=2))), _torch_model(),
                           str(tmp_path / "both"), "cpu"), [])


def test_experiment_switches_tf32_off(tmp_path):
    """Experiment leaves both TF32 switches off without the caller's help."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        Experiment(TConfig(_hparams()), _torch_model(), str(tmp_path), "cpu")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
