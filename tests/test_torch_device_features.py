"""The port's training frontends against the JAX package's: the numpy linear
resize against OpenCV's, the operator banks, the host features
(``features_host.windowed_features``), the on-device features
(``device_train_features``, plain torch on the CPU here) against the JAX
function and against the port's own host path with the same knobs, and a
raw-mode train step at narrow widths.

Tolerances: the resize and the banks are bit-exact against OpenCV (≤ 1e-6
asked); host features ≤ 1e-5 to the JAX ones; device features ≤ 1e-4 to the
JAX ones (two float32 DFT products in another order); device against host in
the port: the tolerances of ``tests/test_device_features.py``; the raw-mode
train step: loss terms 1e-5 relative, parameters 1e-5 absolute.
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.data import device_features as jdfeat
from sdfa_tpu.data import features_host as jhost
from sdfa_tpu_torch.data import device_features as dfeat
from sdfa_tpu_torch.data import features_host

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

SR, WIN, HOP, NMELS = 8000, 512, 64, 128
MEL_CFG = dict(win_size=WIN, hop_size=HOP, n_mels=NMELS, fmin=50, fmax=3600,
               ref_db=20, top_db=80, preemphasis=0.65, win_fn="hamm",
               normalize=True, clip_normalized=True, subtract_mean=False,
               padding=False)


def _spec(module, n_mels=NMELS):
    return module.FeatureSpec(sr=SR, win_size=WIN, hop_size=HOP, n_mels=n_mels, fmin=50,
                              fmax=3600, ref_db=20, top_db=80)


def _signal(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.02 * rng.normal(size=n)).astype(np.float32)


# -- the resize and the operator banks ---------------------------------------------
@pytest.mark.parametrize("shape,size", [((133, 60), (64, 128)), ((123, 72), (64, 128)),
                                        ((128, 56), (64, 128)), ((7, 5), (13, 3)),
                                        ((40, 90), (90, 41))])
def test_linear_resize_is_opencvs_bit_for_bit(shape, size):
    rng = np.random.default_rng(sum(shape))
    for scale in (1e-3, 1.0, 30.0):
        img = (rng.uniform(-1, 1, shape) * scale).astype(np.float32)
        want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        got = features_host.linear_resize(img, *size)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    dyadic = (np.round(rng.uniform(-8, 8, shape)) / 8).astype(np.float32)  # exact midpoints
    assert np.array_equal(features_host.linear_resize(dyadic, *size),
                          cv2.resize(dyadic, size, interpolation=cv2.INTER_LINEAR))


def test_time_op_bank_matches_jax():
    got, want = dfeat.time_op_bank(), jdfeat.time_op_bank()
    assert got.shape == want.shape == (9, dfeat.T_EXT, dfeat.T_OUT)
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.parametrize("n_mels", [128, 80, 16])
def test_freq_op_bank_matches_jax(n_mels):
    got, want = dfeat.freq_op_bank(n_mels), jdfeat.freq_op_bank(n_mels)
    assert got.shape == want.shape == (88, n_mels, n_mels)
    assert float(np.abs(got - want).max()) <= 1e-6
    for f_idx in range(88):  # freq_variant inverts freq_variant_index
        assert dfeat.freq_variant_index(*dfeat.freq_variant(f_idx)) == f_idx


# -- host features: port vs JAX ------------------------------------------------------
HOST_KNOBS = {
    "plain": {},
    "extra": dict(feat_extra=(3, -2)),
    "extra-lower-trunc": dict(feat_extra=(-4, 3)),
    "tremolo": dict(feat_tremolo=0.7),
    "scale-noise": dict(feat_scale=np.exp(np.linspace(-0.1, 0.1, NMELS))[:, None],
                        feat_noise=0.01),
    "dropout": dict(feat_dropout=0.1),
    "pink-noise": dict(signal_noise="pink@0.02"),
    "white-noise-all": dict(signal_noise="white@0.01", feat_extra=(5, 4), feat_tremolo=0.3,
                            feat_scale=np.exp(np.linspace(0.1, -0.1, NMELS))[:, None],
                            feat_dropout=0.15),
}


@pytest.mark.parametrize("knobs", sorted(HOST_KNOBS))
def test_windowed_features_match_jax(knobs):
    """The same knobs and the same generator state on both sides: the same
    random draws, and features within 1e-5."""
    sig = _signal(seed=7)
    out = []
    for module in (jhost, features_host):
        feat, wav, args = module.windowed_features(
            signal=sig, signal_stt=4000, signal_end=4000 + 4544, mel_cfg=dict(MEL_CFG), sr=SR,
            frames=64, rng=np.random.default_rng(11), **HOST_KNOBS[knobs])
        out.append((feat, wav, args))
    (fj, wj, aj), (ft, wt, at) = out
    assert ft.shape == fj.shape == (3, NMELS, 64) and ft.dtype == np.float32
    np.testing.assert_array_equal(wt, wj)
    assert sorted(at) == sorted(aj)
    for key in aj:
        np.testing.assert_array_equal(np.asarray(at[key]), np.asarray(aj[key]))
    assert float(np.abs(ft - fj).max()) <= 1e-5


# -- device features: port vs JAX ----------------------------------------------------
def _raw_batch(n, seed, n_mels=NMELS, t_idx=None, f_idx=None):
    rng = np.random.default_rng(seed)
    length = dfeat.raw_window_samples(WIN, HOP)
    t = np.arange(length) / SR
    raw = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (n, 1)) * t)
           * (1 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5, (n, 1)) * t))
           + 0.02 * rng.normal(size=(n, length))).astype(np.float32)
    return [raw,
            rng.uniform(0, 0.95, n).astype(np.float32),
            (rng.integers(0, 9, n) if t_idx is None else t_idx).astype(np.int32),
            (rng.integers(0, 88, n) if f_idx is None else f_idx).astype(np.int32),
            np.exp(rng.uniform(-0.15, 0.15, (n, n_mels))).astype(np.float32),
            (rng.uniform(size=(n, n_mels)) < 0.08).astype(np.float32),
            (rng.uniform(size=n) < 0.5).astype(np.float32),
            rng.uniform(0.3, 0.6, n).astype(np.float32)]


def _both(args, n_mels=NMELS):
    want = np.asarray(jdfeat.device_train_features(*[jnp.asarray(a) for a in args],
                                                   spec=_spec(jdfeat, n_mels)))
    got = dfeat.device_train_features(*[torch.from_numpy(a) for a in args],
                                      spec=_spec(dfeat, n_mels))
    return got.numpy(), want


@pytest.mark.parametrize("case", ["every-et", "every-freq-variant", "scale-and-dropout",
                                  "narrow-16-mels"])
def test_device_features_match_jax(case):
    if case == "every-et":
        args = _raw_batch(9, 1, t_idx=np.arange(9), f_idx=np.full(9, 40))
    elif case == "every-freq-variant":
        args = _raw_batch(88, 2, t_idx=np.full(88, 4), f_idx=np.arange(88))
    elif case == "scale-and-dropout":
        args = _raw_batch(12, 3)
    else:
        args = _raw_batch(10, 4, n_mels=16)
    n_mels = args[4].shape[1]
    got, want = _both(args, n_mels)
    assert got.shape == want.shape == (len(args[0]), 64, n_mels, 3)
    assert float(np.abs(got - want).max()) <= 1e-4


# -- device features against the port's host path (tests/test_device_features.py) ---
def _host(sig, stt, end, **aug):
    feat = features_host.windowed_features(signal=sig, signal_stt=stt, signal_end=end,
                                           mel_cfg=dict(MEL_CFG), sr=SR, frames=64, **aug)[0]
    return np.transpose(feat, (2, 1, 0))  # (T, F, 3)


def _device(sig, stt, end, preemph=0.65, et=0, f_variant=None, feat_scale=None,
            drop_rows=None, drop_is_max=0.0, drop_thres=0.0):
    ext = dfeat.MAX_EX_TIME * HOP
    raw = features_host.slice_window(sig, stt - ext, end + ext)
    if f_variant is None:
        f_variant = dfeat.freq_variant_index(0, False, False, "constant")
    out = dfeat.device_train_features(
        torch.from_numpy(raw[None]), torch.tensor([preemph]),
        torch.tensor([et + dfeat.MAX_EX_TIME], dtype=torch.int32),
        torch.tensor([f_variant], dtype=torch.int32),
        torch.from_numpy(np.asarray(feat_scale if feat_scale is not None else np.ones(NMELS),
                                    np.float32)[None]),
        torch.from_numpy(np.asarray(drop_rows if drop_rows is not None else np.zeros(NMELS),
                                    np.float32)[None]),
        torch.tensor([drop_is_max]), torch.tensor([drop_thres]), spec=_spec(dfeat))
    return out.numpy()[0]


def test_device_matches_host_without_augmentation():
    sig = _signal()
    host, dev = _host(sig, 4000, 4000 + 4544), _device(sig, 4000, 4000 + 4544)
    np.testing.assert_allclose(dev, host, atol=2e-3)
    np.testing.assert_allclose(dev[..., 0], host[..., 0], atol=5e-4)


@pytest.mark.parametrize("et", [-4, -1, 2, 4])
def test_device_matches_host_time_extension(et):
    sig = _signal(seed=1)
    host = _host(sig, 5000, 5000 + 4544, feat_extra=(0, et),
                 random_args=dict(trunck=False, pad_mode="constant", lower_freq=False))
    np.testing.assert_allclose(_device(sig, 5000, 5000 + 4544, et=et)[..., 0], host[..., 0],
                               atol=2e-3)


@pytest.mark.parametrize("ef,lower,trunc,mode", [(3, False, False, "reflect"),
                                                 (3, True, True, "constant"),
                                                 (-4, False, False, "constant"),
                                                 (5, False, True, "reflect"),
                                                 (2, True, False, "constant")])
def test_device_matches_host_freq_extension(ef, lower, trunc, mode):
    sig = _signal(seed=2)
    host = _host(sig, 6000, 6000 + 4544, feat_extra=(ef, 0),
                 random_args=dict(trunck=trunc, pad_mode=mode, lower_freq=lower))
    dev = _device(sig, 6000, 6000 + 4544,
                  f_variant=dfeat.freq_variant_index(ef, lower, trunc, mode))
    np.testing.assert_allclose(dev[..., 0], host[..., 0], atol=2e-3)


def test_device_matches_host_scale_and_zero_dropout():
    sig = _signal(seed=3)
    rng = np.random.default_rng(4)
    scale = np.exp(rng.uniform(-0.15, 0.15, NMELS)).astype(np.float32)
    drop_idx = rng.choice(NMELS, 10, replace=False)
    drop = np.zeros(NMELS, np.float32)
    drop[drop_idx] = 1.0
    host = _host(sig, 3000, 3000 + 4544, feat_scale=scale[:, None], feat_dropout=10 / NMELS,
                 random_args=dict(mask_idx=drop_idx, drop_mode="zero", mask_thres=0.5,
                                  trunck=False, pad_mode="constant", lower_freq=False))
    dev = _device(sig, 3000, 3000 + 4544, feat_scale=scale, drop_rows=drop)
    np.testing.assert_allclose(dev[..., 0], host[..., 0], atol=2e-3)
    assert float(np.abs(dev[:, drop_idx, 0]).max()) == 0.0


def test_device_matches_host_max_dropout_mode_is_a_no_op():
    sig = _signal(seed=5)
    rng = np.random.default_rng(6)
    drop_idx = rng.choice(NMELS, 12, replace=False)
    drop = np.zeros(NMELS, np.float32)
    drop[drop_idx] = 1.0
    host = _host(sig, 2000, 2000 + 4544, feat_dropout=12 / NMELS,
                 random_args=dict(mask_idx=drop_idx, drop_mode="max", mask_thres=0.45,
                                  trunck=False, pad_mode="constant", lower_freq=False))
    dev = _device(sig, 2000, 2000 + 4544, drop_rows=drop, drop_is_max=1.0, drop_thres=0.45)
    np.testing.assert_allclose(dev[..., 0], host[..., 0], atol=2e-3)
    # "max" mode is a silent no-op in the reference (get_features.py:191-192)
    np.testing.assert_array_equal(host, _host(sig, 2000, 2000 + 4544))


def test_host_train_features_is_the_host_path_of_a_raw_batch():
    """``host_train_features`` (the card check's reference) against the device
    path on random knobs of every kind: the device path's own tolerance."""
    args = _raw_batch(16, 8)
    dev = dfeat.device_train_features(*[torch.from_numpy(a) for a in args],
                                      spec=_spec(dfeat)).numpy()
    for i in range(16):
        host = dfeat.host_train_features(*(a[i] for a in args[:7]), mel_cfg=MEL_CFG, sr=SR)
        np.testing.assert_allclose(dev[i], host, atol=2e-3)
        np.testing.assert_allclose(dev[i][..., 0], host[..., 0], atol=5e-4)


# -- a raw-mode train step, port vs JAX at narrow widths -----------------------------
def _raw_train_batch(seed, bsz=8, n_mels=16):
    from test_torch_train_step import KR, KS

    args = _raw_batch(bsz, seed, n_mels=n_mels)
    rng = np.random.default_rng(seed + 100)
    half = rng.integers(0, 2, (bsz // 2,)).astype(np.int32)
    from sdfa_tpu_torch.train.trainer import RAW_KEYS

    batch = dict(zip(RAW_KEYS, args))
    batch.update(speaker_id=np.concatenate([half, half]),
                 anime_weight=rng.uniform(0.5, 2.0, bsz).astype(np.float32),
                 dgrad_3d_scale_coef=rng.normal(0, 1, (bsz, 1, KS)).astype(np.float32),
                 dgrad_3d_rotat_coef=rng.normal(0, 1, (bsz, 1, KR)).astype(np.float32))
    return batch


def test_raw_mode_train_steps_match_jax(tmp_path):
    """Two steps from the same weights on raw batches: the features are made
    inside each side's loss (``make_loss_fn`` → ``device_train_features``).

    Held: the loss terms of both steps (1e-5 relative); the first step's
    gradients (1e-5 of the largest gradient); the parameters after it (1e-5)
    wherever |g| ≥ 1e-7, ten times Adam's eps. Adam divides each gradient by
    its own size, so where a gradient is zero but for rounding (weight-norm
    gains that feed BatchNorm, components of the attention's bias under a
    near-uniform softmax) the update is noise on both sides: the two
    frontends' features differ by 5e-6, enough to move such a parameter by a
    few hundredths of lr. The loss weights of ``loss.anime_loss_weight`` are
    on; the unweighted loss is ``tests/test_torch_train_step.py``'s."""
    from test_torch_nn import _perturb
    from test_torch_train_step import _hparams, _jax_model, _torch_model

    from sdfa_tpu.models import losses as JL
    from sdfa_tpu.train import trainer as jtrainer
    from sdfa_tpu.utils.config import ConfigDict as JConfig
    from sdfa_tpu_torch.compat import load_flax_variables, state_dict_from_flax
    from sdfa_tpu_torch.config import ConfigDict as TConfig
    from sdfa_tpu_torch.train import Experiment
    from sdfa_tpu_torch.train.trainer import SCALER_NAMES

    hp = _hparams()
    hp["audio"]["mel"] = dict(MEL_CFG, n_mels=16)
    hp["loss"]["anime_loss_weight"] = "anime_weight"
    jhp, jmodel = JConfig(hp), _jax_model()
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jmodel.init({"params": k, "dropout": k},
                                           jnp.zeros((2, 64, 16, 3)), jnp.zeros((2,), jnp.int32),
                                           False))
    variables = _perturb(variables, np.random.default_rng(9))
    tx, lr_fn, _, _, _ = jtrainer.make_optimizer(jhp)
    scalers = {n: JL.ScalerState.init() for n in SCALER_NAMES}
    state = jtrainer.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        constants=variables["constants"], opt_state=tx.init(variables["params"]),
        scalers=scalers, step=jnp.zeros((), jnp.int32))
    step_fn = jtrainer.make_train_step(jmodel, jhp, tx, donate=False)
    loss_fn = jtrainer.make_loss_fn(jmodel, jhp)
    exp = Experiment(TConfig(hp), _torch_model(), str(tmp_path), "cpu")
    load_flax_variables(exp.model, variables)
    for step in range(2):
        batch = _raw_train_batch(30 + step)
        jbatch = {k2: jnp.asarray(v) for k2, v in batch.items()}
        if step == 0:
            grads = jax.jit(jax.grad(lambda p: loss_fn(p, variables["batch_stats"],
                                                       variables["constants"], scalers, jbatch,
                                                       jax.random.PRNGKey(0), True)[0]))(
                variables["params"])
        lr = float(lr_fn(jnp.asarray(step + 1)))
        state, want = step_fn(state, jbatch, jax.random.PRNGKey(step), jnp.asarray(lr),
                              jnp.asarray(0.9))
        got = exp.train_step(batch)
        for key, val in want.items():
            assert float(got[key]) == pytest.approx(float(val), rel=1e-5, abs=1e-9), (step, key)
        if step:
            continue
        want_g = state_dict_from_flax(jax.device_get(dict(variables, params=grads)))
        got_g = {n: p.grad for n, p in exp.model.named_parameters()}
        largest = max(float(g.abs().max()) for g in want_g.values())
        worst = max((float((got_g[n] - want_g[n]).abs().max()), n) for n in got_g)
        assert worst[0] <= 1e-5 * largest, (worst, largest)
        want_sd = state_dict_from_flax(jax.device_get({"params": state.params,
                                                       "batch_stats": state.batch_stats,
                                                       "constants": state.constants}))
        got_sd = exp.model.state_dict()
        for name, val in want_sd.items():
            held = want_g[name].abs() >= 1e-7 if name in want_g else torch.ones_like(val).bool()
            assert float((got_sd[name] - val).abs().where(held, 0.0).max()) < 1e-5, name
