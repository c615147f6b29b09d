"""The recurrent kernels at the widths the JAX package runs them past the
cluster step: H = 384 and 512 (the wide step loop of
``sdfa_tpu_torch/csrc/bilstm_layer.cuh``), inputs to 1024, FreqLstm at
H = 256 / 384 with a ragged output width. On the CPU, with numpy-seeded
inputs at few rows and steps (rows <= 16, T <= 6, F <= 4):

- the port's plain versions against the JAX package's references, and its
  Pallas kernels in interpret mode where they take the shape: K4
  ``bilstm_layer_reference`` / ``bilstm_layer_fused``, K2
  ``bilstm_2layer_reference``, K1 ``freq_lstm_reference`` /
  ``freq_lstm_fused``, K5 ``bilstm_core(interpret=True)`` forward and
  gradient. 1e-5, f32 on both sides (gradients relative to the largest);
- the wide step loop's tiling walked in plain tensors (its waves of row
  tiles, its runs of 16 units, the order its k tiles are added in, the
  projection's k tiles past 512 inputs) against the plain version;
- both wide models of ``chip_smoke.py``'s ``wide_variants`` phase at their
  real recurrent widths (FreqLstm H = 256 / out 512 and a 2-layer time stack
  at H = 512; FreqLstm H = 384 / out 384 and a 3-layer time stack at H = 384)
  over a clip of 4 windows of 8 frames, the heads narrow: the forward against
  the flax model within 5e-5 per branch (``tests/test_e2e_parity.py:192``),
  one train step's loss terms within 1e-5 relative and its gradients within
  1e-4 of the largest, weights carried across by ``compat/from_flax.py``
  (BatchNorm on batch statistics, dropout 0: the two frameworks' random
  streams differ).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import _perturb
from test_torch_train_step import KR, KS, N_TRIS, _batch, _hparams, _pca

from sdfa_tpu.models import losses as JL
from sdfa_tpu.models.sdfa import SpeechDrivenAnimation as JModel
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.ops import pallas_bilstm_train as J5
from sdfa_tpu.ops.pallas_bilstm import bilstm_layer_fused, bilstm_layer_reference
from sdfa_tpu.ops.pallas_bilstm2 import bilstm_2layer_reference
from sdfa_tpu.ops.pallas_freq_lstm import freq_lstm_fused, freq_lstm_reference
from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.compat import load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.ops import bilstm2 as K2
from sdfa_tpu_torch.ops import bilstm_core as K5
from sdfa_tpu_torch.ops import bilstm_layer as K4
from sdfa_tpu_torch.ops import freq_lstm as K1
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.train.trainer import SCALER_NAMES

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 1e-5        # f32 on both sides, sums in another order
TOL_JAX = 5e-5    # the forward budget against the JAX package's Pallas kernels
BUDGET = 5e-5     # a model's forward per branch
GRAD_REL = 1e-4   # a train step's gradients, over the largest


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _layer(rng, n_in, hid, bias=True):
    return [_rand(rng, (2, n_in, 4 * hid), n_in ** -0.5),
            _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
            _rand(rng, (2, 4 * hid), 0.1) if bias else None]


def _freq(rng, rows, n_freq, n_in, hid, out, bias=True):
    return ([_rand(rng, (rows, n_freq, n_in), 1.0)] + _layer(rng, n_in, hid, bias)
            + [_rand(rng, (n_freq * 2 * hid, out), 0.02),
               _rand(rng, (out,), 0.1) if bias else None])


def _both(args):
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else torch.from_numpy(a) for a in args])


def _err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


# --- the plain versions against the JAX package ---------------------------------------

@pytest.mark.parametrize("rows,steps,n_in,hid,bias", [
    (3, 3, 384, 384, True), (16, 3, 768, 384, False), (3, 6, 1024, 512, True),
    (7, 2, 100, 512, False)])
def test_layer_plain_matches_reference(rows, steps, n_in, hid, bias):
    """K4 at H = 384 and 512, inputs to 1024 (a 2H-wide second layer) and one
    that JAX scans (100); the Pallas kernel in interpret mode where it takes
    the shape (input a multiple of 128)."""
    rng = np.random.default_rng(rows + n_in)
    jx, tx = _both([_rand(rng, (rows, steps, n_in), 0.5)] + _layer(rng, n_in, hid, bias))
    got = K4.bilstm_layer(*tx).numpy()  # CPU tensors → the plain version
    assert got.shape == (rows, steps, 2 * hid)
    assert _err(got, bilstm_layer_reference(*jx)) < TOL
    if n_in % 128 == 0 and rows <= 8:
        assert _err(got, bilstm_layer_fused(*jx, block_rows=8, interpret=True)) < TOL_JAX


@pytest.mark.parametrize("rows,steps,n_in,hid", [(6, 3, 512, 512), (9, 2, 384, 384)])
def test_bilstm2_plain_matches_reference(rows, steps, n_in, hid):
    rng = np.random.default_rng(20 + rows)
    args = ([_rand(rng, (rows, steps, n_in), 0.5)] + _layer(rng, n_in, hid)
            + _layer(rng, 2 * hid, hid))
    jx, tx = _both(args)
    got = K2.bilstm2(*tx).numpy()
    assert got.shape == (rows, steps, 2 * hid)
    assert _err(got, bilstm_2layer_reference(*jx)) < TOL


@pytest.mark.parametrize("rows,n_freq,n_in,hid,out,bias", [
    (8, 4, 64, 256, 512, True), (5, 3, 64, 384, 384, True), (7, 4, 16, 256, 200, False),
    (3, 2, 8, 384, 200, True)])
def test_freq_lstm_plain_matches_reference(rows, n_freq, n_in, hid, out, bias):
    """K1 at H = 256 / out 512 and H = 384 / out 384 (the wide models'), and a
    ragged out of 200; the Pallas kernel in interpret mode on two of them."""
    rng = np.random.default_rng(30 + rows)
    jx, tx = _both(_freq(rng, rows, n_freq, n_in, hid, out, bias))
    got = K1.freq_lstm(*tx).numpy()
    assert got.shape == (rows, out)
    assert _err(got, freq_lstm_reference(*jx)) < TOL
    if n_in == 64 or out == 200 and bias:
        want = freq_lstm_fused(*jx, block_rows=8, interpret=True, precise=True)
        assert _err(got, want) < TOL_JAX


def _core_inputs(steps, rows, hid, seed):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (2, steps, rows, 4 * hid), 0.5),
            _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
            _rand(rng, (steps, rows, 2 * hid), 1.0))


def _torch_grads(fn, xp, w_hh, dout):
    txp, tw = torch.from_numpy(xp).requires_grad_(), torch.from_numpy(w_hh).requires_grad_()
    out = fn(txp, tw)
    gx, gw = torch.autograd.grad(out, (txp, tw), torch.from_numpy(dout))
    return out.detach().numpy(), gx.numpy(), gw.numpy()


def _rel(got, want):
    return _err(got, want) / (float(np.abs(want).max()) + 1e-12)


@pytest.mark.parametrize("steps,rows,hid", [(2, 3, 384), (2, 2, 512)])
def test_core_matches_pallas_interpret_forward_and_gradient(steps, rows, hid):
    """K5 at H = 384 and 512: the port's plain version (autograd of the scan)
    and its ``autograd.Function`` (the kernels' step in plain tensors)
    against ``bilstm_core(interpret=True)`` and ``jax.grad`` of it."""
    xp, w_hh, dout = _core_inputs(steps, rows, hid, seed=hid + rows)

    def loss(a, b):
        return jnp.sum(jnp.asarray(dout) * J5.bilstm_core(a, b, block_rows=8, interpret=True))

    want_out = np.asarray(J5.bilstm_core(jnp.asarray(xp), jnp.asarray(w_hh), block_rows=8,
                                         interpret=True))
    want_x, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(w_hh))
    for fn in (K5.bilstm_core_plain, K5.BilstmCore.apply):
        out, gx, gw = _torch_grads(fn, xp, w_hh, dout)
        assert _err(out, want_out) < TOL
        assert _rel(gx, want_x) < TOL and _rel(gw, want_w) < TOL


# --- the wide step loop's tiling, walked in plain tensors ------------------------------

@pytest.mark.parametrize("rows,steps,n_in,hid,capacity", [
    (16, 5, 1024, 512, None),   # one wave; the projection's k tiles past 512
    (40, 3, 1000, 384, 48),     # 48 blocks: one row tile of 64 a wave, so 40 rows in one
    (70, 2, 64, 384, 48),       # one row tile a wave: two waves, the last of 6 rows
    (9, 2, 8, 640, None),       # H = 640: 40 runs of 16 units
    (5, 2, 8, 1024, None)])     # H = 1024: 64 runs of 16 units
def test_wide_layer_tiled_matches_plain(rows, steps, n_in, hid, capacity):
    rng = np.random.default_rng(40 + rows)
    tx = [torch.from_numpy(a) for a in [_rand(rng, (rows, steps, n_in), 0.5)]
          + _layer(rng, n_in, hid)]
    got = K4.bilstm_layer_tiled(*tx, capacity=capacity)
    assert float((got - K4.bilstm_layer_plain(*tx)).abs().max()) < TOL
    stack = _layer(rng, 2 * hid, hid, bias=False)
    got2 = K2.bilstm2_tiled(*tx, *(torch.from_numpy(a) if a is not None else None
                                   for a in stack), capacity=capacity)
    want2 = K2.bilstm2_plain(*tx, *(torch.from_numpy(a) if a is not None else None
                                    for a in stack))
    assert float((got2 - want2).abs().max()) < TOL


@pytest.mark.parametrize("steps,rows,hid,capacity", [
    (3, 16, 384, None), (2, 40, 512, 64), (1, 7, 384, None),
    (2, 65, 384, 48),   # one row tile of 64 a wave: one row past the first wave
    (2, 9, 640, None),  # 40 runs of 16 units
    (2, 5, 1024, None)])  # 64 runs
def test_wide_core_tiled_matches_plain(steps, rows, hid, capacity):
    """K5's wide forward (gates and c saved at their time index) and backward
    (the previous step's d_pre read back from dg) walked per wave, row tile
    and unit run, against the plain step and BPTT."""
    xp, w_hh, dout = (torch.from_numpy(a) for a in _core_inputs(steps, rows, hid, seed=7))
    got = K5.forward_steps_tiled(xp, w_hh, capacity=capacity)
    want = K5.forward_steps(xp, w_hh)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < TOL
    dg = K5.backward_steps_tiled(*want[1:], w_hh, dout, capacity=capacity)
    assert _rel(dg.numpy(), K5.backward_steps(*want[1:], w_hh, dout).numpy()) < TOL


@pytest.mark.parametrize("rows,n_freq,hid,out,groups", [
    (37, 3, 256, 200, 2), (40, 2, 384, 384, 2), (5, 4, 384, 201, 30),
    (9, 2, 640, 100, 2),     # 40 runs of 16 units
    (40, 2, 1024, 64, 2)])   # 128 blocks: one row tile of 64 a wave
def test_wide_freq_tiled_matches_plain(rows, n_freq, hid, out, groups):
    """K1 at H = 256 (the layer kernels' cluster step) and 384 (the wide loop,
    its waves the chunk's), the output projection in K slabs at any width."""
    rng = np.random.default_rng(50 + rows)
    tx = [None if a is None else torch.from_numpy(a)
          for a in _freq(rng, rows, n_freq, 12, hid, out)]
    got = K1.freq_lstm_tiled(*tx, groups=groups)
    assert got.shape == (rows, out)
    assert float((got - K1.freq_lstm_plain(*tx)).abs().max()) < TOL


def test_projection_walks_k_tiles_past_512():
    """The input projection's k tiles of 32 in 3xTF32, the last one partial,
    against one float32 product: 1024 and 1000 inputs, with and without the
    gate bias."""
    rng = np.random.default_rng(60)
    for n_in in (1024, 1000):
        x = torch.from_numpy(_rand(rng, (3, 2, n_in), 1.0))
        w_ih, _, gb = (torch.from_numpy(a) for a in _layer(rng, n_in, 384))
        want = torch.stack([x @ w_ih[d] + gb[d] for d in range(2)])
        assert float((K4.projection_tiled(x, w_ih, gb) - want).abs().max()) < TOL
        assert float((K4.projection_tiled(x, w_ih, None) - (want - gb[:, None, None])).abs()
                     .max()) < TOL


@pytest.mark.parametrize("hid,capacity,rows", [(384, 396, 512), (512, 396, 384), (640, 396, 256),
                                               (1024, 396, 192), (384, 23, 0), (8192, 396, 0),
                                               (384, 528, 704), (512, 528, 512),
                                               (3072, 396, 64), (3200, 396, 0)])
def test_wide_wave_rows(hid, capacity, rows):
    """Rows one cooperative launch takes: whole row tiles of 64 whose 2 H / 16
    blocks each fit the resident blocks (the forward's three a multiprocessor,
    396 on an H100; the backward's four, 528); none where not one tile fits
    (from H = 3200 at 396)."""
    assert K4.wide_wave_rows(hid, capacity) == rows


# --- both wide models against the flax model -------------------------------------------

WIDE = {  # FreqLstm, the time stack, the attention's width (2H of the time stack)
    "wide512": (("freq-lstm", 64, 32, "hidden_size=256", "output_size=512"),
                ("lstm", 512, 512, "num_layers=2", "bidirectional=True", "dropout=0.0"), 1024),
    "wide384": (("freq-lstm", 64, 32, "hidden_size=384", "output_size=384"),
                ("lstm", 384, 384, "num_layers=3", "bidirectional=True"), 768)}
LRELU = "act=lrelu@a:0.2"
FRAMES, WINDOWS = 8, 4


def _wide_models(name):
    shipped = [tuple(s) for s in tconfigure("dgrad").model.audio_encoder.layers]
    conv, (_, squeeze, permute, _, _) = shipped[:6], shipped[6:]
    freq, lstm, width = WIDE[name]
    enc = conv + [freq, squeeze, permute, lstm, ("attn", "bah", width, 128, 2,
                                                 "scale_score_at_eval=1.0")]
    trunk = [("fc", width + 2, 16, LRELU, "cat_condition=2")]
    head_s = [("fc", 16 + 2, 16, "act=tanh", "cat_condition=2"), ("fc", 16, KS, "act=linear")]
    head_r = [("fc", 16 + 2, 16, "act=tanh", "cat_condition=2"), ("fc", 16, KR, "act=linear")]
    pca = _pca()
    jmodel = JModel(encoder_specs=freeze_specs(enc), output_specs=freeze_specs(trunk),
                    output_scale_specs=freeze_specs(head_s),
                    output_rotat_specs=freeze_specs(head_r), face_type="dgrad_3d",
                    pred_type="face_data", using_pca=True, weight_norm=True, num_speakers=2,
                    output_dim_scale=6 * N_TRIS, output_dim_rotat=3 * N_TRIS,
                    pca_coeffs_scale=KS, pca_coeffs_rotat=KR,
                    pca_scale_init=lambda: pca["scale"], pca_rotat_init=lambda: pca["rotat"])
    tmodel = TModel(enc, trunk, head_s, head_r, 6 * N_TRIS, 3 * N_TRIS, KS, KR,
                    weight_norm=True, num_speakers=2)
    for part, (comp, means) in pca.items():
        getattr(tmodel, f"{part}_pca").load_bases(comp, means)
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(jax.jit(jmodel.init, static_argnums=3)(
        {"params": k, "dropout": k}, jnp.zeros((2, FRAMES, 128, 3)), jnp.zeros((2,), jnp.int32),
        False))
    return jmodel, _perturb(variables, np.random.default_rng(7)), tmodel


def _wide_batch(seed):
    batch = _batch(seed, coef=True, bsz=WINDOWS)
    rng = np.random.default_rng(seed)
    batch["audio_feat"] = rng.normal(0.4, 0.3, (WINDOWS, FRAMES, 128, 3)).astype(np.float32)
    return batch


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_model_serves_and_trains_like_jax(name, tmp_path):
    jmodel, variables, tmodel = _wide_models(name)
    load_flax_variables(tmodel.eval(), variables)
    batch = _wide_batch(11)
    feats, spk = batch["audio_feat"], batch["speaker_id"].astype(np.int32)
    jpreds, _, _ = jax.jit(jmodel.apply, static_argnums=3)(variables, jnp.asarray(feats),
                                                           jnp.asarray(spk), False)
    with torch.no_grad():
        tpreds, _ = tmodel(torch.from_numpy(feats), torch.from_numpy(spk).long(), decode=True)
    for key in ("dgrad_3d_scale", "dgrad_3d_rotat"):
        assert _err(tpreds[key].numpy(), jpreds[key]) < BUDGET, key

    hp = _hparams()
    hp["audio"]["mel"]["n_mels"] = 128
    jhp = JConfig(hp)
    loss_fn = jtrainer.make_loss_fn(jmodel, jhp)
    scalers = {n: JL.ScalerState.init() for n in SCALER_NAMES}
    (_, aux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=6)(
        variables["params"], variables["batch_stats"], variables["constants"], scalers,
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), True)
    exp = Experiment(TConfig(hp), tmodel, str(tmp_path), "cpu")
    load_flax_variables(exp.model, variables)
    got = exp.train_step(batch)
    want = {**jax.device_get(aux["scalars"]), **jax.device_get(aux["loss_terms"])}
    for key, val in want.items():
        assert float(got[key]) == pytest.approx(float(val), rel=1e-5, abs=1e-9), key
    want_g = state_dict_from_flax({"params": jax.device_get(jgrads)})
    got_g = {n: p.grad for n, p in exp.model.named_parameters()}
    assert sorted(want_g) == sorted(got_g)
    largest = max(float(g.abs().max()) for g in want_g.values())
    worst = max((float((got_g[n] - g).abs().max()), n) for n, g in want_g.items())
    assert worst[0] <= GRAD_REL * largest, (worst, largest)
