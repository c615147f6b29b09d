"""Training-mode layers and losses of the port against the JAX package on the
same weights (through the weight bridge) and the same numpy-seeded inputs:
``LSTM`` and ``FreqLstm`` through the training core (outputs and parameter
gradients), BatchNorm on batch statistics (outputs and updated running
statistics), the attention's eval-only score scale, the losses and the
dynamic scaler, the lr schedules; then dropout, which cannot share JAX's
random stream, for its rate, its scaling and its reproducibility.

Tolerance 2e-5 on outputs and 3e-5 × max |gradient| on gradients: f32 on
both sides (JAX at HIGHEST), sums in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import BN, LRELU, _flax_vars, _t

from sdfa_tpu.models import losses as JL
from sdfa_tpu.nn import LayerStack as JStack
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.nn import recurrent as jrec
from sdfa_tpu.train import lr_schedules as jsched
from sdfa_tpu_torch.compat import load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.models import losses as TL
from sdfa_tpu_torch.nn import layers as tlayers
from sdfa_tpu_torch.nn import recurrent as trec
from sdfa_tpu_torch.nn.spec import LayerStack as TStack
from sdfa_tpu_torch.train import lr_schedules as tsched

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 2e-5


def _grad_pair(jmod, tmod, variables, x, w_out, jargs=(True,)):
    """Loss Σ w_out·module(x) on both sides → (outputs, parameter gradients
    keyed like the state_dict)."""
    def jloss(params):
        out = jmod.apply({**variables, "params": params}, jnp.asarray(x), *jargs,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(jnp.asarray(w_out) * out), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tout = tmod(_t(x))
    (tout * _t(w_out)).sum().backward()
    want = state_dict_from_flax({"params": jax.device_get(jgrads)})
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert sorted(got) == sorted(want)
    return np.asarray(jout), tout.detach().numpy(), want, got


def _assert_grads(want, got):
    for name, w in want.items():
        scale = float(w.abs().max()) + 1e-12
        assert float((got[name] - w).abs().max()) <= 3e-5 * scale, name


@pytest.mark.parametrize("num_layers,bias", [(1, True), (2, False), (3, True)])
def test_lstm_training_matches_flax(num_layers, bias):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 7, 12)).astype(np.float32)
    w_out = rng.normal(0, 1, (3, 7, 32)).astype(np.float32)
    jmod = jrec.LSTM(input_size=12, hidden_size=16, num_layers=num_layers, bias=bias,
                     bidirectional=True)  # dropout 0: the random streams differ
    variables = _flax_vars(jmod, jnp.asarray(x))
    tmod = trec.LSTM(12, 16, num_layers=num_layers, bias=bias, bidirectional=True).train()
    load_flax_variables(tmod, variables)
    jout, tout, want, got = _grad_pair(jmod, tmod, variables, x, w_out)
    assert tout.shape == (3, 7, 32)
    assert float(np.abs(tout - jout).max()) < TOL
    _assert_grads(want, got)


def test_freq_lstm_training_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 8, 6, 5)).astype(np.float32)  # (B, C, F, T)
    w_out = rng.normal(0, 1, (2, 12, 1, 5)).astype(np.float32)
    jmod = jrec.FreqLstm(input_size=8, freq_length=6, hidden_size=16, output_size=12)
    variables = _flax_vars(jmod, jnp.asarray(x))
    tmod = load_flax_variables(trec.FreqLstm(8, 6, hidden_size=16, output_size=12),
                               variables).train()
    jout, tout, want, got = _grad_pair(jmod, tmod, variables, x, w_out)
    assert float(np.abs(tout - jout).max()) < TOL
    _assert_grads(want, got)


def test_training_lstm_goes_through_the_core(monkeypatch):
    """Training routes every layer through ``bilstm_core`` (its plain version
    under ``ops.plain_versions()``); eval does not."""
    from sdfa_tpu_torch import ops

    calls = []
    monkeypatch.setattr(trec, "bilstm_core",
                        lambda xp, w: calls.append("core") or trec.bilstm_core_plain(xp, w))
    mod = trec.LSTM(6, 4, num_layers=2, bidirectional=True)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(1))
    want = mod.train()(x)
    assert calls == ["core", "core"]
    with ops.plain_versions():
        torch.testing.assert_close(mod(x), want, rtol=0, atol=0)
    assert calls == ["core", "core"]
    torch.testing.assert_close(mod.eval()(x), want, rtol=1e-6, atol=1e-6)
    assert calls == ["core", "core"]


@pytest.mark.parametrize("num_layers", [1, 3])
def test_eval_stack_not_two_deep_goes_through_bilstm_layer(monkeypatch, num_layers):
    """In eval mode a stack that is not 2 layers deep calls the per-layer
    wrapper once per layer (a kernel launch on a card), never the plain
    version directly."""
    calls = []
    monkeypatch.setattr(trec, "bilstm_layer", lambda *a: calls.append("layer")
                        or trec.bilstm_layer_plain(*a))
    mod = trec.LSTM(6, 4, num_layers=num_layers, bidirectional=True).eval()
    mod.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = mod(torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(1)))
    assert out.shape == (2, 5, 8) and calls == ["layer"] * num_layers


def test_batchnorm_training_outputs_and_running_stats_match_flax():
    specs = [("conv2d", 3, 5, (3, 1), (1, 1), LRELU, BN),
             ("conv2d", 5, 4, (1, 1), (1, 1), BN, "act=tanh", "bn_first=True")]
    rng = np.random.default_rng(6)
    x = rng.normal(0.3, 1.0, (4, 3, 9, 6)).astype(np.float32)
    jstack = JStack(specs=freeze_specs(specs), weight_norm=True, tag="t")
    variables = _flax_vars(jstack, jnp.asarray(x), None)
    tstack = load_flax_variables(TStack(specs, True, tag="t"), variables).train()
    (want, _), mutated = jstack.apply(variables, jnp.asarray(x), None, True,
                                      mutable=["batch_stats"])
    got, _ = tstack(_t(x))
    assert float(np.abs(got.detach().numpy() - np.asarray(want)).max()) < TOL
    stats = state_dict_from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])})
    own = tstack.state_dict()
    assert len(stats) == 4
    for name, val in stats.items():
        assert float((own[name] - val).abs().max()) < 1e-6, name
    # the running variance moved by the BIASED batch variance, momentum 0.01
    layer = tstack.built_layers_0
    act = torch.nn.functional.leaky_relu(
        torch.nn.functional.conv2d(torch.nn.functional.pad(_t(x), (0, 0, 1, 1)),
                                   layer.weight(), layer.bias), 0.2)
    biased = act.var(dim=(0, 2, 3), unbiased=False)
    start = _t(variables["batch_stats"]["built_layers_0"]["post_bn"]["var"])
    torch.testing.assert_close(layer.post_bn.var, 0.99 * start + 0.01 * biased,
                               rtol=1e-5, atol=1e-7)
    # eval uses the running statistics and moves nothing
    before = {k: v.clone() for k, v in tstack.state_dict().items()}
    want_eval, _ = jstack.apply({**variables, "batch_stats": mutated["batch_stats"]},
                                jnp.asarray(x), None, False)
    with torch.no_grad():
        got_eval, _ = tstack.eval()(_t(x))
    assert float(np.abs(got_eval.numpy() - np.asarray(want_eval)).max()) < TOL
    assert all(torch.equal(v, before[k]) for k, v in tstack.state_dict().items())


def test_attention_score_scale_applies_at_eval_only():
    specs = [("attn", "bah", 8, 4, 2, "scale_score_at_eval=3.0")]
    x = np.random.default_rng(7).normal(0, 1, (2, 6, 8)).astype(np.float32)
    jstack = JStack(specs=freeze_specs(specs), weight_norm=False, tag="t")
    variables = _flax_vars(jstack, jnp.asarray(x), None)
    tstack = load_flax_variables(TStack(specs, False, tag="t"), variables)
    outs = {}
    for training in (True, False):
        want, want_al = jstack.apply(variables, jnp.asarray(x), None, training)
        with torch.no_grad():
            got, got_al = tstack.train(training)(_t(x))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL
        (ja,), (ta,) = want_al.values(), got_al.values()
        assert float(np.abs(ta.numpy() - np.asarray(ja)).max()) < TOL
        outs[training] = got
    assert float((outs[True] - outs[False]).abs().max()) > 1e-3


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    n, tris = 6, 7
    ps, ts = (rng.normal(0, 0.3, (n, 1, tris * 6)).astype(np.float32) for _ in range(2))
    pr, tr = (rng.normal(0, 0.3, (n, 1, tris * 3)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.5, 1.5, (n,)).astype(np.float32)
    ev = rng.normal(0, 1, (n, 5)).astype(np.float32)
    pairs = [
        (JL.ploss_flat(ps, ts, w, group=6), TL.ploss_flat(_t(ps), _t(ts), _t(w), group=6)),
        (JL.mloss_flat(ps, ts, w, group=6), TL.mloss_flat(_t(ps), _t(ts), _t(w), group=6)),
        (JL.ploss_flat(pr, tr, w, group=3, exp_values=True),
         TL.ploss_flat(_t(pr), _t(tr), _t(w), group=3, exp_values=True)),
        (JL.mloss_flat(pr, tr, w, group=3, exp_values=True),
         TL.mloss_flat(_t(pr), _t(tr), _t(w), group=3, exp_values=True)),
        (JL.eloss(jnp.asarray(ev)), TL.eloss(_t(ev))),
    ]
    for face_data in (True, False):  # the 3-wide rotation branch exp()s only for face data
        kw = dict(is_dgrad=True, is_face_data=face_data)
        p4, t4 = pr.reshape(n, 1, tris, 3), tr.reshape(n, 1, tris, 3)
        pairs.append((JL.ploss(p4, t4, w, **kw), TL.ploss(_t(p4), _t(t4), _t(w), **kw)))
        pairs.append((JL.mloss(p4, t4, w, **kw), TL.mloss(_t(p4), _t(t4), _t(w), **kw)))
    for want, got in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    # the flat form equals the (…, tris, k) form
    assert float(pairs[2][1]) == pytest.approx(float(pairs[5][1]), rel=1e-5)


def test_dynamic_scale_matches_jax_and_detaches_the_scale():
    jstate, tstate = JL.ScalerState.init(), TL.ScalerState.init()
    for step, val in enumerate((0.5, 0.2, 0.9)):
        want, jstate = JL.dynamic_scale(jnp.asarray(val), jstate, True)
        loss = torch.tensor(val, requires_grad=True)
        got, tstate = TL.dynamic_scale(loss, tstate, True)
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
        for a, b in zip(tstate, jstate):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
        # d(loss / scale)/d(loss) = 1 / scale: no gradient through the mean square
        (grad,) = torch.autograd.grad(got, loss)
        assert float(grad) == pytest.approx(float(got.detach()) / val, rel=1e-5)
    want, _ = JL.dynamic_scale(jnp.asarray(0.4), jstate, False)
    got, same = TL.dynamic_scale(torch.tensor(0.4), tstate, False)
    assert float(got) == pytest.approx(float(want), rel=1e-6) and same is tstate
    fresh, _ = TL.dynamic_scale(torch.tensor(0.4), TL.ScalerState.init(), False)
    assert float(fresh) == pytest.approx(0.4)  # never updated: scale 1


SCHEDULES = [
    ("Constant", {}), ("ExpDecay", dict(gamma=0.9, start_iter=5, gap_iters=3, min_scale=0.3)),
    ("NoamDecay", dict(warmup_iters=7)),
    ("NoamZero", dict(warmup_iters=4, start_ramp=12, total_iters=30, base_beta1=0.9)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_lr_schedules_match_jax(name, args):
    jlr, jb1, jmode = jsched.build(name, 2e-3, dict(args, mode="step"))
    tlr, tb1, tmode = tsched.build(name, 2e-3, dict(args, mode="step"))
    assert tmode == jmode == "step" and (tb1 is None) == (jb1 is None)
    for it in (0, 1, 2, 4, 7, 11, 12, 20, 29, 45):
        assert tlr(it) == pytest.approx(float(jlr(jnp.asarray(it))), rel=1e-5), it
        if tb1 is not None:
            assert tb1(it) == pytest.approx(float(jb1(jnp.asarray(it))), rel=1e-5), it
    assert tsched.build(None, 1e-3)[2] == "epoch"
    with pytest.raises(ValueError):
        tsched.build("Cosine", 1e-3)


def test_dropout_rate_scaling_and_seed():
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(200, 500)
    y = tlayers.dropout(x, 0.3, gen)
    kept = y != 0
    assert float(kept.float().mean()) == pytest.approx(0.7, abs=0.01)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    gen.manual_seed(3)
    assert torch.equal(tlayers.dropout(x, 0.3, gen), y)
    gen.manual_seed(4)
    assert not torch.equal(tlayers.dropout(x, 0.3, gen), y)
    with pytest.raises(RuntimeError):
        tlayers.dropout(x, 0.3, None)


def test_layer_dropout_modes_and_generator_plumbing():
    """``dropout=`` on a layer drops in training only, ``drop_always`` at eval
    too; the LSTM drops between layers in training only; all draw from the
    generator that ``set_dropout_generator`` hands them."""
    specs = [("fc", 6, 8, "dropout=0.5"), ("fc", 8, 8, "dropout=0.5", "drop_always=True"),
             ("lstm", 8, 4, "num_layers=2", "bidirectional=True", "dropout=0.5")]
    stack = TStack(specs, False, tag="t")
    gen = torch.Generator().manual_seed(0)
    for module in stack.layers:
        module.reset_parameters(gen)
    x = torch.randn(3, 5, 6, generator=gen)
    with pytest.raises(RuntimeError):
        stack.train()(x)  # no generator yet
    tlayers.set_dropout_generator(stack, gen)

    def run(training, seed):
        gen.manual_seed(seed)
        with torch.no_grad():
            return stack.train(training)(x)[0]

    assert torch.equal(run(True, 1), run(True, 1))
    assert not torch.equal(run(True, 1), run(True, 2))
    assert torch.equal(run(False, 1), run(False, 1))
    assert not torch.equal(run(False, 1), run(False, 2))  # drop_always is live at eval
    stack.built_layers_1.drop_always = False
    assert torch.equal(run(False, 1), run(False, 2))      # now eval is deterministic
    assert not torch.equal(run(True, 1), run(False, 1))
