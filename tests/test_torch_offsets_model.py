"""The model family beyond dgrad, port vs JAX on the same flax variables: the
offsets model (``verts_off_3d``, one trunk into one PCA inversion), positions
(``verts_pos_3d``), the ``pca_coeffs`` / ``pca_normal`` prediction types,
trainable PCA bases, the learned speaker embedding and a model without PCA,
each through ``forward``, ``forward_windows``, ``decode_to_anime`` and
training steps at narrow widths (dropout 0: the two frameworks' random streams
cannot match); the shipped ``configs/model/offsets.py`` built at full width.
The network here has no weight norm and its convs no bias: a weight-norm gain
or a bias that feeds BatchNorm has a true gradient of zero, which Adam turns
into an update of rounding noise, of any size up to the learning rate on
either side (weight norm in training is held by tests/test_torch_train_step.py).

Tolerances: forward ≤ 5e-5 per branch (tests/test_e2e_parity.py's budget);
loss terms 1e-5 relative at every step, parameters after the last step 1e-5
absolute, scaler states 1e-6 (tests/test_torch_train_step.py's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import _perturb
from test_torch_train_step import ADAMW_NOAM_CLIP, BN, LRELU
from test_torch_train_step import _hparams as _dgrad_hparams
from test_torch_train_step import _torch_model as _dgrad_torch_model

from sdfa_tpu.models import build_model as jbuild
from sdfa_tpu.models import losses as JL
from sdfa_tpu.models.sdfa import SpeechDrivenAnimation as JModel
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.compat import (flax_variables_from_model, load_flax_variables,
                                   state_dict_from_flax)
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.models import build_model as tbuild
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.train.trainer import scaler_names

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

FWD_TOL = 5e-5
D_OUT, K, KS, KR, EMB = 30, 5, 5, 4, 3

# name → the model's options; every one but the last two is the offsets trunk
VARIANTS = {
    "offsets": dict(face_type="verts_off_3d"),
    "positions": dict(face_type="verts_pos_3d"),
    "offsets-pca_coeffs": dict(face_type="verts_off_3d", pred_type="pca_coeffs"),
    "positions-pca_normal": dict(face_type="verts_pos_3d", pred_type="pca_normal"),
    "offsets-trainable_pca": dict(face_type="verts_off_3d", pca_trainable=True),
    "offsets-learned_speaker": dict(face_type="verts_off_3d", speaker_onehot=False),
    "positions-no_pca": dict(face_type="verts_pos_3d", using_pca=False),
    "dgrad-trainable_pca-learned_speaker": dict(face_type="dgrad_3d", pca_trainable=True,
                                                speaker_onehot=False),
}


def _specs(opts):
    cond = 2 if opts.get("speaker_onehot", True) else EMB
    enc = [
        ("permute", (0, 3, 2, 1)),
        ("conv2d", 3, 4, (3, 1), (1, 1), "bias=False", LRELU, BN),
        ("pool2d", "max", (2, 1)),
        ("conv2d", 4, 6, (1, 1), (1, 1), "bias=False", LRELU, BN),
        ("freq-lstm", 6, 8, "hidden_size=8", "output_size=12"),
        ("squeeze", 2),
        ("permute", (0, 2, 1)),
        ("lstm", 12, 8, "num_layers=2", "bidirectional=True", "dropout=0.0"),
        ("attn", "bah", 16, 8, 2, "scale_score_at_eval=2.0"),
    ]
    trunk = [("fc", 16 + cond, 8, LRELU, "cat_condition=2")]
    if opts["face_type"] != "dgrad_3d":
        width = K if opts.get("using_pca", True) else D_OUT
        return enc, trunk + [("fc", 8, 8, "act=tanh"), ("fc", 8, width, "act=linear")], (), ()
    head = [("fc", 8 + cond, 8, "act=tanh", "cat_condition=2")]
    return enc, trunk, head + [("fc", 8, KS, "act=linear")], head + [("fc", 8, KR, "act=linear")]


def _bases(seed=99):
    rng = np.random.default_rng(seed)

    def pair(out, k):
        return (rng.normal(0, 0.1, (out, k)).astype(np.float32),
                rng.normal(0, 0.01, (out,)).astype(np.float32))

    return {"pca": pair(D_OUT, K), "scale": pair(6 * 10, KS), "rotat": pair(3 * 10, KR)}


def _common(opts):
    return dict(face_type=opts["face_type"], pred_type=opts.get("pred_type", "face_data"),
                using_pca=opts.get("using_pca", True),
                pca_trainable=opts.get("pca_trainable", False), weight_norm=False,
                num_speakers=2, speaker_onehot=opts.get("speaker_onehot", True),
                speaker_embedding_size=EMB)


def _jax_model(opts):
    enc, trunk, head_s, head_r = _specs(opts)
    bases = _bases()
    kw = dict(encoder_specs=freeze_specs(enc), output_specs=freeze_specs(trunk), **_common(opts))
    if opts["face_type"] == "dgrad_3d":
        kw.update(output_scale_specs=freeze_specs(head_s), output_rotat_specs=freeze_specs(head_r),
                  output_dim_scale=60, output_dim_rotat=30, pca_coeffs_scale=KS,
                  pca_coeffs_rotat=KR, pca_scale_init=lambda: bases["scale"],
                  pca_rotat_init=lambda: bases["rotat"])
    else:
        kw.update(output_dim=D_OUT, pca_coeffs=K, pca_init=lambda: bases["pca"])
    return JModel(**kw)


def _torch_model(opts):
    enc, trunk, head_s, head_r = _specs(opts)
    if opts["face_type"] == "dgrad_3d":
        model = TModel(enc, trunk, head_s, head_r, 60, 30, KS, KR, **_common(opts))
    else:
        model = TModel(enc, trunk, output_dim=D_OUT, pca_coeffs=K, **_common(opts))
    for part, (comp, means) in _bases().items():
        sub = getattr(model, part if part == "pca" else f"{part}_pca", None)
        if sub is not None:
            sub.load_bases(comp, means)
    return model


def _variables(jmodel, seed=7):
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jmodel.init({"params": k, "dropout": k},
                                           jnp.zeros((2, 8, 16, 3)), jnp.zeros((2,), jnp.int32),
                                           False))
    return _perturb(variables, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def built():
    """One JAX model and one perturbed set of its variables per variant, built
    on first use and shared by the forward and the training tests (neither
    changes them: the port's copies are made by ``load_flax_variables``)."""
    cache = {}

    def get(name):
        if name not in cache:
            jmodel = _jax_model(VARIANTS[name])
            cache[name] = (jmodel, _variables(jmodel))
        return cache[name]

    return get


def _max_diff(got: dict, want: dict) -> float:
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k].detach().numpy() - np.asarray(want[k])).max()) for k in want)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_windows_and_decode_match_flax(built, name):
    """forward (both ways), forward_windows (both ways) and decode_to_anime on
    the same variables; the state bridges back to the same flax tree."""
    opts = VARIANTS[name]
    (jmodel, variables), tmodel = built(name), _torch_model(opts)
    load_flax_variables(tmodel, variables).eval()
    rng = np.random.default_rng(3)
    feat = rng.normal(0.4, 0.3, (4, 8, 16, 3)).astype(np.float32)
    spk = np.array([0, 1, 1, 0], np.int32)
    ft, st = torch.from_numpy(feat), torch.from_numpy(spk).long()

    want, _, _ = jmodel.apply(variables, feat, spk, False)
    with torch.no_grad():
        got, _ = tmodel(ft, st, decode=True)
        got_raw, _ = tmodel(ft, st)
        assert _max_diff(got, want) <= FWD_TOL
        # the keys say what a dict holds; decode_to_anime takes either
        want_anime = np.asarray(jmodel.decode_to_anime(variables, want))
        for preds in (got, got_raw):
            assert float(np.abs(tmodel.decode_to_anime(preds).numpy() - want_anime).max()) \
                <= FWD_TOL
        postfix = "_pca" if tmodel.using_pca else ""
        if opts["face_type"] == "dgrad_3d":
            assert sorted(got_raw) == [f"dgrad_3d_rotat{postfix}", f"dgrad_3d_scale{postfix}"]
        else:
            assert list(got_raw) == [f"{opts['face_type']}{postfix}"]

        # the windowed suffix from the clip's per-frame prefix
        clip = rng.normal(0.4, 0.3, (20, 16, 3)).astype(np.float32)
        frame_idx = np.stack([np.arange(i, i + 8) for i in (0, 5, 12)]).astype(np.int32)
        spk_w = np.array([1, 0, 1], np.int32)
        z_j = jmodel.apply(variables, clip, method=JModel.encode_frames)
        z_t = tmodel.encode_frames(torch.from_numpy(clip))
        assert float(np.abs(z_t.numpy() - np.asarray(z_j)).max()) <= FWD_TOL
        for raw in (False, True):
            want_w, _, _ = jmodel.apply(variables, z_j, frame_idx, spk_w, raw_pca=raw,
                                        method=JModel.forward_windows)
            got_w, _, _ = tmodel.forward_windows(z_t, torch.from_numpy(frame_idx).long(),
                                                 torch.from_numpy(spk_w).long(), raw_pca=raw)
            assert _max_diff(got_w, want_w) <= FWD_TOL, raw

    tree = flax_variables_from_model(tmodel)
    for col in ("params", "constants"):
        want_keys = sorted(state_dict_from_flax({col: variables.get(col, {})}))
        assert sorted(state_dict_from_flax({col: tree[col]})) == want_keys, col
    if not opts.get("speaker_onehot", True):
        assert tree["params"]["speaker_embedding"]["Embed_0"]["embedding"].shape == (2, EMB)


def _hparams(opts, extra=None):
    hp = _dgrad_hparams(**(extra or {}))
    hp["model"] = dict(face_data_type=opts["face_type"],
                       prediction_type=opts.get("pred_type", "face_data"))
    return hp


def _batch(seed, opts, targets, bsz=8):
    """First half frame i, second half frame i + 1, as the loader ships them."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 2, (bsz // 2,)).astype(np.int32)
    batch = {"audio_feat": rng.normal(0.4, 0.3, (bsz, 8, 16, 3)).astype(np.float32),
             "speaker_id": np.concatenate([half, half])}
    face = opts["face_type"]
    if face == "dgrad_3d":
        batch["dgrad_3d_scale"] = rng.normal(0, 0.1, (bsz, 1, 10, 6)).astype(np.float32)
        batch["dgrad_3d_rotat"] = rng.normal(0, 0.1, (bsz, 1, 10, 3)).astype(np.float32)
    elif targets == "coef":
        batch[f"{face}_coef"] = rng.normal(0, 1, (bsz, 1, K)).astype(np.float32)
    elif targets == "pca":
        batch[f"{face}_pca"] = rng.normal(0, 1, (bsz, 1, K)).astype(np.float32)
    else:
        batch[face] = rng.normal(0, 0.05, (bsz, 1, D_OUT)).astype(np.float32)
    return batch


# (variant, steps, targets, optimizer and trainer sections)
TRAIN_CASES = [
    ("offsets", 3, "full", None),
    ("offsets", 3, "coef", None),
    ("offsets", 3, "coef", ADAMW_NOAM_CLIP),
    ("positions", 1, "full", None),
    ("offsets-pca_coeffs", 1, "pca", None),
    ("positions-pca_normal", 1, "pca", None),
    ("offsets-trainable_pca", 1, "full", None),
    ("offsets-learned_speaker", 1, "coef", None),
    ("positions-no_pca", 1, "full", None),
    ("dgrad-trainable_pca-learned_speaker", 1, "full", None),
]
# Held by losses and gradients, not by the parameters after the step: under a
# near-uniform softmax the attention query kernel's gradient is about 1e-9 and
# rounding moves it by 6e-10, which Adam's first step makes a 1.1e-5 difference
# of parameters. The gradients agree to 8e-7 of the largest.
GRADIENTS_ONLY = {"positions-no_pca"}
GRAD_RTOL = 1e-5  # first step: max |diff| over the model's largest |gradient|


@pytest.mark.parametrize("name,steps,targets,extra", TRAIN_CASES,
                         ids=[f"{c[0]}-{c[1]}steps-{c[2]}{'-adamw_noam_clip' if c[3] else ''}"
                              for c in TRAIN_CASES])
def test_train_steps_match_jax(built, tmp_path, name, steps, targets, extra):
    opts = VARIANTS[name]
    hp = _hparams(opts, extra)
    jhp, (jmodel, variables) = JConfig(hp), built(name)
    names = jtrainer._scaler_names(opts["face_type"])
    assert scaler_names(opts["face_type"]) == names

    tx, lr_fn, beta1_fn, mode, _ = jtrainer.make_optimizer(jhp)
    state = jtrainer.TrainState(
        params=variables["params"], batch_stats=variables.get("batch_stats", {}),
        constants=variables.get("constants", {}), opt_state=tx.init(variables["params"]),
        scalers={n: JL.ScalerState.init() for n in names}, step=jnp.zeros((), jnp.int32))
    step_fn = jtrainer.make_train_step(jmodel, jhp, tx, donate=False)

    exp = Experiment(TConfig(hp), _torch_model(opts), str(tmp_path), "cpu")
    load_flax_variables(exp.model, variables)
    assert sorted(exp.scalers) == sorted(names)

    for step in range(steps):
        batch = _batch(10 + step, opts, targets)
        if step == 0 and name in GRADIENTS_ONLY:
            loss_fn = jtrainer.make_loss_fn(jmodel, jhp)
            grads = jax.grad(lambda p: loss_fn(
                p, state.batch_stats, state.constants, state.scalers,
                {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                True)[0])(state.params)
            want_grads = state_dict_from_flax({"params": jax.device_get(grads)})
        it = step + 1 if mode == "step" else 0
        lr = float(lr_fn(jnp.asarray(it)))
        b1 = float(beta1_fn(jnp.asarray(it))) if beta1_fn else 0.9
        state, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(step), jnp.asarray(lr), jnp.asarray(b1))
        got = exp.train_step(batch)
        if step == 0 and name in GRADIENTS_ONLY:
            got_grads = {n: p.grad for n, p in exp.model.named_parameters()}
            assert sorted(got_grads) == sorted(want_grads)
            largest = max(float(g.abs().max()) for g in want_grads.values())
            worst = max((float((got_grads[n] - g).abs().max()), n) for n, g in want_grads.items())
            assert worst[0] <= GRAD_RTOL * largest, (worst, largest)
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            assert float(got[key]) == pytest.approx(float(val), rel=1e-5, abs=1e-9), (step, key)

    if name in GRADIENTS_ONLY:
        return
    want_sd = state_dict_from_flax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats, "constants": state.constants}))
    got_sd = exp.model.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    worst = max((float((got_sd[key] - want_sd[key]).abs().max()), key) for key in want_sd)
    assert worst[0] < 1e-5, worst
    if opts.get("pca_trainable"):
        moved = [k for k in got_sd if k.endswith("compT")
                 and not torch.equal(got_sd[k], torch.tensor(
                     variables["params"][k.split(".")[0]]["compT"]))]
        assert moved, "trainable PCA bases did not move"
    for n in names:
        for got_v, want_v in zip(exp.scalers[n], state.scalers[n]):
            assert float(got_v) == pytest.approx(float(want_v), abs=1e-6)


def test_checkpoint_of_another_face_type_is_refused(tmp_path):
    """An offsets Experiment resumes from an offsets checkpoint and refuses a
    dgrad one by name, before any tensor is loaded."""
    opts = VARIANTS["offsets"]
    dgrad = Experiment(TConfig(_dgrad_hparams()), _dgrad_torch_model(), str(tmp_path / "d"),
                       "cpu")
    dgrad.save()
    offsets = Experiment(TConfig(_hparams(opts)), _torch_model(opts), str(tmp_path / "o"), "cpu")
    offsets.train_step(_batch(1, opts, "full"))
    offsets.save()
    again = Experiment(TConfig(_hparams(opts)), _torch_model(opts), str(tmp_path / "o2"), "cpu",
                       load_from=str(tmp_path / "o" / "last.ckpt"))
    assert again.step == 1 and sorted(again.scalers) == ["dyn_e", "dyn_m", "dyn_p"]
    for key, val in offsets.scalers.items():
        assert torch.equal(again.scalers[key].vt, val.vt)
    with pytest.raises(ValueError, match="another face type than this 'verts_off_3d' model"):
        Experiment(TConfig(_hparams(opts)), _torch_model(opts), str(tmp_path / "o3"), "cpu",
                   load_from=str(tmp_path / "d" / "last.ckpt"))


def test_shipped_offsets_config_builds_at_full_width():
    """configs/model/offsets.py: 15069 outputs behind 59 coefficients, the
    dgrad encoder, and exactly the JAX model's variables, name for name and
    shape for shape (the JAX side traced by ``jax.eval_shape``, no compute)."""
    hp = configure("offsets")
    rng = np.random.default_rng(0)
    pca = {"compT": rng.normal(0, 0.01, (15069, 59)).astype(np.float32),
           "means": rng.normal(0, 0.01, (15069,)).astype(np.float32)}
    model = tbuild(hp, pca=pca)
    assert (model.face_type, model.pred_type) == ("verts_off_3d", "face_data")
    assert tuple(model.pca.compT.shape) == (15069, 59) and not model.pca_trainable
    assert torch.equal(model.pca.compT, torch.from_numpy(pca["compT"]))
    assert model.split > 0  # the overlap path: encode once per clip, suffix per window

    jmodel = jbuild(jconfigure("offsets"), load_pca=False)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((2, 64, 128, 3)), jnp.zeros((2,), jnp.int32), False))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {k.split(".", 1)[1]: v for k, v in want.items()}  # drop the collection
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 6260502

    with pytest.raises(NotImplementedError, match="not ported"):
        tbuild(configure("offsets", overrides={"model": {"face_data_type": "marks_pos_2d"}}),
               pca=pca)
