"""Three model variants built from the layers the shipped configs do not
use, port vs the JAX ``SpeechDrivenAnimation`` on the same weights (through
the weight bridge) at narrow widths, the shapes of ``chip_smoke.py``'s
``spec_variants`` phase cut down:

- ``freq_last_gmm``: FreqLstm "last", a 3-layer biLSTM, GMM attention;
- ``lstm2d_prod``: LSTM2d ending the per-frame prefix, permute / flatten / fc,
  a 2-layer biLSTM, dot-product attention;
- ``gru_extras``: the shipped encoder with ``mul-noise`` (a constant factor:
  std 0, so that both frameworks train on the same numbers) and ``gradx``
  after FreqLstm, a 2-layer biGRU as the time stack, a head fc with
  ``prev_activation`` and ``prev_batch_norm``.

Each is served (the per-window forward, and the overlap path — per-frame
prefix once, ``forward_windows`` per window — with both decode layouts) and
takes one optimization step (``Experiment.train_step`` against
``make_train_step``; BatchNorm on batch statistics, dropout 0). A dgrad model
without PCA heads builds and decodes as the JAX one does, and serves through
the decode, the equation gather and the product (the kernel takes PCA
coefficients) within 1e-4 m of the float64 solve of its own frames.

The JAX side runs under ``jax.jit`` (init, forward and decode too: flax's
eager dispatch took twice the time). Tolerances: the forward 5e-5 per branch (``tests/test_e2e_parity.py:192``);
the step's loss terms 1e-5 relative, the parameters after it 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import BN, LRELU, _perturb
from test_torch_slice import narrow_model
from test_torch_train_step import KR, KS, N_TRIS, _batch, _hparams, _pca

from sdfa_tpu.models import losses as JL
from sdfa_tpu.models.sdfa import SpeechDrivenAnimation as JModel
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.compat import init_params, load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.models import build_model as tbuild
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.task import AnimationTask
from sdfa_tpu_torch.viewer import frame as tframe
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.train.trainer import SCALER_NAMES

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

BUDGET = 5e-5
CONV = [("permute", (0, 3, 2, 1)),
        ("conv2d", 3, 4, (3, 1), (1, 1), LRELU, BN),
        ("pool2d", "max", (2, 1)),
        ("conv2d", 4, 6, (1, 1), (1, 1), LRELU, BN)]  # (N, 6, 8, T)
PBN = "prev_batch_norm={'momentum': 0.01, 'eps': 0.001}"
VARIANTS = {
    "freq_last_gmm": CONV + [
        ("freq-lstm", 6, 8, "hidden_size=8", "output_size=12", "mode=last"),
        ("squeeze", 2), ("permute", (0, 2, 1)),
        ("lstm", 12, 8, "num_layers=3", "bidirectional=True"),
        ("attn", "gmm", 16, 8, 2, "num_k=3")],
    "lstm2d_prod": CONV + [
        ("lstm2d", 6, 4, "num_layers=2"),
        ("permute", (0, 3, 1, 2)), ("flatten", 2), ("fc", 64, 12),
        ("lstm", 12, 8, "num_layers=2", "bidirectional=True"),
        ("attn", "prod", 16, 8, 2)],
    "gru_extras": CONV + [
        ("freq-lstm", 6, 8, "hidden_size=8", "output_size=12"),
        ("mul-noise", 1.4, 0.5, 0.0), ("gradx", 0.5),
        ("squeeze", 2), ("permute", (0, 2, 1)),
        ("gru", 12, 8, "num_layers=2", "bidirectional=True"),
        ("attn", "bah", 16, 8, 2, "scale_score_at_eval=2.0")],
}
SPLITS = {"freq_last_gmm": (7, 1), "lstm2d_prod": (4, 3), "gru_extras": (9, 1)}


def _heads(name, ks=KS, kr=KR):
    trunk = [("fc", 16 + 2, 8, LRELU, "cat_condition=2")]
    extra = ("prev_activation=lrelu@a:0.2", PBN) if name == "gru_extras" else ()
    head_s = [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"),
              ("fc", 8, ks, "act=linear", *extra)]
    head_r = [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"), ("fc", 8, kr, "act=linear")]
    return trunk, head_s, head_r


def _models(name, using_pca=True):
    trunk, head_s, head_r = (_heads(name) if using_pca
                             else _heads(name, 6 * N_TRIS, 3 * N_TRIS))
    enc = VARIANTS[name]
    pca = _pca()
    jmodel = JModel(encoder_specs=freeze_specs(enc), output_specs=freeze_specs(trunk),
                    output_scale_specs=freeze_specs(head_s),
                    output_rotat_specs=freeze_specs(head_r), face_type="dgrad_3d",
                    pred_type="face_data", using_pca=using_pca, weight_norm=True,
                    num_speakers=2, output_dim_scale=6 * N_TRIS, output_dim_rotat=3 * N_TRIS,
                    pca_coeffs_scale=KS if using_pca else 6 * N_TRIS,
                    pca_coeffs_rotat=KR if using_pca else 3 * N_TRIS,
                    pca_scale_init=lambda: pca["scale"], pca_rotat_init=lambda: pca["rotat"])
    tmodel = TModel(enc, trunk, head_s, head_r, 6 * N_TRIS, 3 * N_TRIS, KS, KR,
                    weight_norm=True, num_speakers=2, using_pca=using_pca)
    if using_pca:
        for part, (comp, means) in pca.items():
            getattr(tmodel, f"{part}_pca").load_bases(comp, means)
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jax.jit(jmodel.init, static_argnums=3)(
        {"params": k, "dropout": k}, jnp.zeros((2, 8, 16, 3)), jnp.zeros((2,), jnp.int32),
        False))
    return jmodel, _perturb(variables, np.random.default_rng(7)), tmodel


def _served(jmodel, variables, tmodel):
    """The per-window forward and the overlap path, decoded both ways."""
    rng = np.random.default_rng(5)
    feats = rng.normal(0.4, 0.3, (3, 8, 16, 3)).astype(np.float32)
    spk = np.asarray([0, 1, 1], np.int32)
    jpreds, _, _ = jax.jit(jmodel.apply, static_argnums=3)(variables, jnp.asarray(feats),
                                                           jnp.asarray(spk), False)
    tmodel.eval()
    with torch.no_grad():
        tpreds, _ = tmodel(torch.from_numpy(feats), torch.from_numpy(spk).long(), decode=True)
    for key in ("dgrad_3d_scale", "dgrad_3d_rotat"):
        assert float(np.abs(tpreds[key].numpy() - np.asarray(jpreds[key])).max()) < BUDGET
    clip = rng.normal(0.4, 0.3, (14, 16, 3)).astype(np.float32)
    frame_idx = (np.arange(4)[:, None] * 2 + np.arange(8)[None, :]).astype(np.int32)
    spk = np.asarray([0, 1, 0, 1], np.int32)
    z = jax.jit(lambda v, c: jmodel.apply(v, c, method=JModel.encode_frames))(
        variables, jnp.asarray(clip))
    jpreds, _, _ = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=JModel.forward_windows))(
        variables, z, jnp.asarray(frame_idx), jnp.asarray(spk))
    janime = np.asarray(jax.jit(jmodel.decode_to_anime)(variables, jpreds))
    with torch.no_grad():
        tz = tmodel.encode_frames(torch.from_numpy(clip))
        assert float(np.abs(tz.numpy() - np.asarray(z)).max()) < BUDGET
        tpreds, _, _ = tmodel.forward_windows(tz, torch.from_numpy(frame_idx).long(),
                                              torch.from_numpy(spk).long(), raw_pca=True)
        anime = tmodel.decode_to_anime(tpreds)
        planes = tmodel.decode_to_anime(tpreds, planes=True)
    assert float(np.abs(anime.numpy() - janime).max()) < BUDGET
    per_tri = anime.reshape(4, 1, N_TRIS, 9)
    want_planes = torch.cat([per_tri[..., :6].transpose(-1, -2).reshape(4, 1, -1),
                             per_tri[..., 6:].transpose(-1, -2).reshape(4, 1, -1)], dim=-1)
    assert torch.equal(planes, want_planes)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_serves_and_trains_like_jax(name, tmp_path):
    jmodel, variables, tmodel = _models(name)
    load_flax_variables(tmodel, variables)
    assert (tmodel.split, tmodel.taxis) == SPLITS[name]
    _served(jmodel, variables, tmodel)

    hp = _hparams()
    jhp = JConfig(hp)
    tx, lr_fn, _, _, _ = jtrainer.make_optimizer(jhp)
    state = jtrainer.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        constants=variables["constants"], opt_state=tx.init(variables["params"]),
        scalers={n: JL.ScalerState.init() for n in SCALER_NAMES},
        step=jnp.zeros((), jnp.int32))
    step_fn = jtrainer.make_train_step(jmodel, jhp, tx, donate=False)
    exp = Experiment(TConfig(hp), tmodel, str(tmp_path), "cpu")
    load_flax_variables(exp.model, variables)
    batch = _batch(11, coef=True)
    state, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0), jnp.asarray(float(lr_fn(jnp.asarray(1)))),
                          jnp.asarray(0.9))
    got = exp.train_step(batch)
    for key, val in want.items():
        assert float(got[key]) == pytest.approx(float(val), rel=1e-5, abs=1e-9), key
    want_sd = state_dict_from_flax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats,
         "constants": state.constants}))
    got_sd = exp.model.state_dict()
    assert sorted(want_sd) == sorted(got_sd)
    worst = max((float((got_sd[k] - want_sd[k]).abs().max()), k) for k in want_sd)
    assert worst[0] < 1e-5, worst


def test_dgrad_without_pca_heads_builds_and_decodes_like_jax():
    """``using_pca=False``: the heads give the dgrad frames themselves, and
    ``decode_to_anime`` lays them out as the JAX model does."""
    jmodel, variables, tmodel = _models("freq_last_gmm", using_pca=False)
    load_flax_variables(tmodel.eval(), variables)
    assert not hasattr(tmodel, "scale_pca")
    feats = np.random.default_rng(6).normal(0.4, 0.3, (2, 8, 16, 3)).astype(np.float32)
    spk = np.asarray([1, 0], np.int32)
    jpreds, _, _ = jax.jit(jmodel.apply, static_argnums=3)(variables, jnp.asarray(feats),
                                                           jnp.asarray(spk), False)
    janime = np.asarray(jax.jit(jmodel.decode_to_anime)(variables, jpreds))
    with torch.no_grad():
        tpreds, _ = tmodel(torch.from_numpy(feats), torch.from_numpy(spk).long())
        anime = tmodel.decode_to_anime(tpreds)
    assert sorted(tpreds) == ["dgrad_3d_rotat", "dgrad_3d_scale"]
    assert anime.shape == (2, 1, 9 * N_TRIS)
    assert float(np.abs(anime.numpy() - janime).max()) < BUDGET


def test_dgrad_without_pca_heads_serves_through_the_solve():
    """``AnimationTask.generate_vertices`` on a narrow dgrad model whose heads
    give the frames themselves, over a small template: sampled frames within
    1e-4 m of ``solve_host`` of the model's own decoded frames."""
    verts, faces, cnst = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    net = narrow_model()
    out = dict(net["output"], using_pca=False, output_dim_scale=6 * n, output_dim_rotat=3 * n)
    out["layers_scale"] = out["layers_scale"][:-1] + [("fc", 16, 6 * n, "act=linear")]
    out["layers_rotat"] = out["layers_rotat"][:-1] + [("fc", 16, 3 * n, "act=linear")]
    hp = tconfigure("dgrad", overrides={"model": {"audio_encoder": net["audio_encoder"],
                                                  "output": out}})
    model = init_params(tbuild(hp), 3)
    saved = dict(tframe._state)
    try:
        solver = tframe.set_template_mesh(verts, faces, cnst)
        task = AnimationTask(hp, model, "cpu")
        sr = int(hp.audio.sample_rate)
        sig = (0.3 * np.sin(np.arange(int(0.6 * sr)) * 0.05)).astype(np.float32)
        ts, got = task.generate_vertices(sig, 1)
        assert got.shape == (len(ts), len(verts), 3) and np.isfinite(got).all()
        assert task._decode_consts()[2] is None  # no decode + solve kernel constants
        sample = [0, len(ts) - 1]
        with torch.no_grad():
            frame_idx, _, z, _ = task._overlap_prefix(sig)
            preds, _, _ = model.forward_windows(z, torch.from_numpy(frame_idx[sample]).long(),
                                                torch.ones(2, dtype=torch.long))
            frames = model.decode_to_anime(preds)[:, 0].double().numpy()
        oracle = np.stack([solver.solve_host(f) for f in frames])
        assert float(np.abs(got[sample] - oracle).max()) <= 1e-4
    finally:
        tframe._state.clear()
        tframe._state.update(saved)
