"""``train/stepbench.py::StepEnv`` and the kernels' cost counts on the CPU.

On a generated dataset (a 240-triangle template, the dgrad config at the
narrow widths of ``test_torch_slice.narrow_model``): the held batch is the
JAX reader's first raw batch, array for array; one step's loss terms are
``Experiment.train_step``'s on that batch from the same seed, bit for bit;
the timings are positive; ``cost_stats`` counts what ``FlopCounterMode``
counts over the whole step (on the CPU every op is aten: no kernel
launches) and leaves the state as it found it. Each kernel module's
``cost`` is ``FlopCounterMode``'s count of its plain version at two narrow
shapes, within 1%. ``Experiment.plot_forward`` featurizes a raw-mode batch as
the loss does."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from test_torch_slice import narrow_model

from sdfa_tpu.data import DatasetSlidingWindow as JReader
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import device_features as dfeat
from sdfa_tpu_torch.data import synthetic
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.ops import bilstm2, bilstm_core, bilstm_layer, decode_solve, freq_lstm
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.train.stepbench import ByteCounter, StepEnv
from sdfa_tpu_torch.train.trainer import RAW_KEYS

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

COST_RTOL = 0.01  # a kernel's cost() vs FlopCounterMode of its plain version


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stepbench")
    _, faces, _ = synthetic_template(2, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    saved = synthetic.N_TRIS
    synthetic.N_TRIS = n
    try:
        root = synthetic.generate(str(tmp / "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=1.0)
    finally:
        synthetic.N_TRIS = saved
    net = narrow_model()
    overrides = {"model": {"audio_encoder": net["audio_encoder"],
                           "output": dict(net["output"], output_dim_scale=6 * n,
                                          output_dim_rotat=3 * n)},
                 "trainer": {"pca_targets": True, "anime_loader": {"batch_size": 2}}}
    return tmp, root, overrides, StepEnv(root, str(tmp / "env"), overrides=overrides,
                                         device="cpu", seed=3)


def test_held_batch_is_the_jax_readers_first(env):
    _, root, overrides, se = env
    jhp = jconfigure("dgrad", dataset_root=root, overrides=dict(overrides))
    want = next(iter(JReader(jhp, training=True).raw_batches(2, shuffle=False)))
    assert sorted(se.batch_host) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(se.batch_host[key], val, err_msg=key)
    assert se.n_windows == 4 and sorted(se.batch) == sorted(k for k in want if k != "signal")
    assert se.lr == se.exp.current_lr()[0] and se.b1 == 0.9


def test_one_step_equals_experiment_train_step(env):
    tmp, root, overrides, _ = env
    se = StepEnv(root, str(tmp / "fresh"), overrides=overrides, device="cpu", seed=3)
    hp = configure("dgrad", dataset_root=root, overrides=overrides)
    exp = Experiment(hp, build_model(hp), str(tmp / "plain"), "cpu", seed=3)
    want = exp.train_step(se.batch_host)
    got = se.step(0)
    assert sorted(got) == sorted(want)
    for key in want:
        assert float(got[key]) == float(want[key]), key
    se.sync(got)


def test_timings_are_positive(env):
    se = env[3]
    for value in (se.timed_median_s(2), se.timed_median_s(1, upload=True),
                  se.timed_steady_s(2), se.timed_steady_s(2, upload=True)):
        assert isinstance(value, float) and value > 0


def test_cost_stats_is_the_flop_counters_step_and_undone(env):
    se = env[3]
    before = {k: v.clone() for k, v in se.exp.model.state_dict().items()}
    step, scalers = se.exp.step, dict(se.exp.scalers)
    stats = se.cost_stats()
    assert sorted(stats) == ["bytes", "flops"]
    assert se.cost_parts["kernels"] == {}  # the CPU launches none
    assert all(torch.equal(v, before[k]) for k, v in se.exp.model.state_dict().items())
    assert se.exp.step == step and se.exp.scalers == scalers
    counter = FlopCounterMode(display=False)
    with counter:
        se.step(0)
    assert stats["flops"] == float(counter.get_total_flops()) > 0
    assert stats["bytes"] == se.cost_parts["library"]["bytes"] > 0


def test_byte_counter_counts_operands_not_views():
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    with ByteCounter() as bc:
        c = a @ b  # reads 32 + 16 floats, writes 8
        _ = c.t()  # a view: nothing
        _ = torch.empty(100)
    assert bc.bytes == 4 * (32 + 16 + 8)


def _flops(fn, *args):
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def _randn(seed, *shape, scale=0.3):
    return scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rows,n_freq,n_in", [(3, 4, 6), (5, 2, 8)])
def test_freq_lstm_cost(rows, n_freq, n_in):
    h, out = freq_lstm.HIDDEN, freq_lstm.OUT_DIM
    args = (_randn(1, rows, n_freq, n_in), _randn(2, 2, n_in, 4 * h), _randn(3, 2, h, 4 * h),
            _randn(4, 2, 4 * h), _randn(5, n_freq * 2 * h, out), _randn(6, out))
    flops, moved = freq_lstm.cost(rows, n_freq, n_in)
    assert flops == pytest.approx(_flops(freq_lstm.freq_lstm_plain, *args), rel=COST_RTOL)
    assert moved == 4 * sum(t.numel() for t in args) + 4 * rows * out


@pytest.mark.parametrize("rows,steps,n_in,hidden", [(3, 4, 6, 8), (2, 3, 5, 16)])
def test_bilstm_layer_and_bilstm2_cost(rows, steps, n_in, hidden):
    g = 4 * hidden
    layer1 = (_randn(11, 2, n_in, g), _randn(12, 2, hidden, g), _randn(13, 2, g))
    layer2 = (_randn(14, 2, 2 * hidden, g), _randn(15, 2, hidden, g), _randn(16, 2, g))
    x = _randn(10, rows, steps, n_in)
    flops, moved = bilstm_layer.cost(rows, steps, n_in, hidden)
    assert flops == pytest.approx(_flops(bilstm_layer.bilstm_layer_plain, x, *layer1),
                                  rel=COST_RTOL)
    assert moved == 4 * (sum(t.numel() for t in (x, *layer1)) + rows * steps * 2 * hidden)
    flops, moved = bilstm2.cost(rows, steps, n_in, hidden)
    assert flops == pytest.approx(_flops(bilstm2.bilstm2_plain, x, *layer1, *layer2),
                                  rel=COST_RTOL)
    assert moved == 4 * (sum(t.numel() for t in (x, *layer1, *layer2))
                         + rows * steps * 2 * hidden)


@pytest.mark.parametrize("steps,rows,hidden", [(3, 4, 8), (5, 2, 16)])
def test_bilstm_core_cost(steps, rows, hidden):
    xp, w = _randn(20, 2, steps, rows, 4 * hidden), _randn(21, 2, hidden, 4 * hidden)
    flops, moved = bilstm_core.cost(steps, rows, hidden)
    assert flops == pytest.approx(_flops(bilstm_core.bilstm_core_plain, xp, w), rel=COST_RTOL)
    out, gates, cs = bilstm_core.forward_steps(xp, w)
    assert moved == 4 * sum(t.numel() for t in (xp, w, out, gates, cs))
    dout = _randn(22, steps, rows, 2 * hidden)
    dg = bilstm_core.backward_steps(gates, cs, w, dout)
    assert moved == 4 * sum(t.numel() for t in (gates, cs, w, dout, dg))
    # the backward kernel's product: d_pre · w_hhᵀ a step (dw_hh is a library product)
    assert flops == pytest.approx(_flops(bilstm_core.backward_steps, gates, cs, w, dout),
                                  rel=COST_RTOL)


@pytest.mark.parametrize("windows", [1, 6])
def test_decode_solve_cost(windows):
    verts, faces, cnst = synthetic_template(4, n_major=6, n_minor=8, n_extra=2, n_free=20)
    solver = DeformationSolver(verts, faces, cnst_indices=cnst)
    n, ks, kr = len(faces), 5, 7
    rng = np.random.default_rng(windows)
    dsc = decode_solve.prep_consts(rng.normal(0, 0.02, (6 * n, ks)), rng.normal(0, 0.02, 6 * n),
                                   rng.normal(0, 0.02, (3 * n, kr)), rng.normal(0, 0.02, 3 * n),
                                   solver, "cpu")
    coef_s, coef_r = _randn(30, windows, ks), _randn(31, windows, kr)
    _, tp, nf = dsc.p.shape
    flops, moved = decode_solve.cost(windows, ks, kr, tp, nf)
    assert flops == pytest.approx(_flops(decode_solve.decode_solve_plain, coef_s, coef_r, dsc),
                                  rel=COST_RTOL)
    out_floats = windows * 3 * nf
    inputs = sum(t.numel() for t in (coef_s, coef_r, *dsc)) - dsc.p.numel()
    assert moved == 4 * (inputs + out_floats)


def test_plot_forward_featurizes_a_raw_batch(env):
    se = env[3]
    out = se.exp.plot_forward(se.batch_host)
    with torch.no_grad():
        want = dfeat.device_train_features(
            *(torch.from_numpy(np.asarray(se.batch_host[k])) for k in RAW_KEYS),
            spec=dfeat.FeatureSpec.from_hparams(se.exp.hp))
    assert torch.equal(out["audio_feat"], want)
    n_tris = se.exp.model.scale_pca.compT.shape[0] // 6
    assert tuple(out["prediction"]["dgrad_3d_scale"].shape) == (4, 1, 6 * n_tris)
