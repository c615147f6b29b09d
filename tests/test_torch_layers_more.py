"""The spec layers the shipped configs do not use, port vs the JAX package on
the same weights (through the weight bridge) and numpy-seeded inputs at
narrow widths, each through the spec engine as a config would name it: the
pre-layer extras (activation, BatchNorm named ``prev_bn`` before or after it),
``fp``, the transposed convs with ``output_padding`` and ``want_size``,
``pool1d``, the reshape layers, ``gradx`` (forward and gradient), ``res1d``
and ``mul-noise``; in eval mode and in training mode (BatchNorm on batch
statistics, its running statistics after the step too; dropout 0). Then the
time-independent prefix split against the JAX rules for every layer name.

Tolerances: outputs and running statistics 1e-5 (f32 on both sides, JAX at
HIGHEST, sums in another order); gradients 1e-4 of the largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import BN, LRELU, _stack_pair, _t

from sdfa_tpu.nn import spec as jspec
from sdfa_tpu_torch.compat import flax_variables_from_model
from sdfa_tpu_torch.nn import layers as tlayers
from sdfa_tpu_torch.nn import spec as tspec

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 1e-5


def _eval_and_train(specs, x):
    """The stack in eval mode, then in training mode with its updated
    running statistics, against flax."""
    jstack, variables, tstack = _stack_pair(specs, x)
    want = np.asarray(jstack.apply(variables, jnp.asarray(x))[0])
    with torch.no_grad():
        got = tstack(_t(x))[0].numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < TOL
    (want_t, _), new_state = jstack.apply(variables, jnp.asarray(x), None, True,
                                          mutable=["batch_stats"],
                                          rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got_t = tstack.train()(_t(x))[0].numpy()
    assert float(np.abs(got_t - np.asarray(want_t)).max()) < TOL
    want_stats = jax.device_get(new_state).get("batch_stats", {})
    got_stats = flax_variables_from_model(tstack)["batch_stats"]
    _same_tree(want_stats, got_stats)
    return tstack


def _same_tree(want, got):
    assert sorted(want) == sorted(got)
    for key, val in want.items():
        if hasattr(val, "items"):
            _same_tree(val, got[key])
        else:
            assert float(np.abs(np.asarray(val) - got[key]).max()) < TOL, key


PBN = "prev_batch_norm={'momentum': 0.1, 'eps': 0.001}"
EXTRAS = {
    "fc": [("fc", 6, 5, "prev_activation=lrelu@a:0.2", PBN, "act=tanh")],
    "fc-bn-first": [("fc", 6, 5, "prev_activation=tanh", PBN, "prev_bn_first=True", BN)],
    "conv1d": [("permute", (0, 2, 1)),
               ("conv1d", 6, 4, 3, "prev_activation=relu", PBN, LRELU, BN)],
    "fp": [("permute", (0, 2, 1)), ("fp", 6, 4, False, "prev_activation=tanh", LRELU)],
    "conv2d": [("unsqueeze", 1), ("conv2d", 1, 3, (3, 1), (1, 1), PBN, "prev_bn_first=True",
                                  "prev_activation=relu")],
    "deconv1d": [("permute", (0, 2, 1)),
                 ("deconv1d", 6, 4, 3, 2, "same", 1, "want_size=14", PBN, LRELU)],
    "deconv2d": [("unsqueeze", 1), ("deconv2d", 1, 3, (3, 2), (2, 1), "same", 1, (1, 2),
                                    "prev_activation=tanh", BN)],
    "deconv2d-want": [("unsqueeze", 1), ("deconv2d", 1, 2, 3, 2, "same", 0, 1, 1, True,
                                         (14, 12))],
    "pool1d": [("permute", (0, 2, 1)), ("pool1d", "max", 3, 2), ("pool1d", "avg", 2, 1, 1)],
    "reshape": [("unsqueeze", -1), ("transpose", 1, 3), ("flatten", 2), ("identity",),
                ("view", (3, 7, 6)), ("gradx", 0.5)],
    "res1d": [("permute", (0, 2, 1)), ("res1d", 6, 4, 2, BN), ("res1d", 4, 4, 1, BN,
                                                              "last_activation=tanh")],
}


@pytest.mark.parametrize("name", list(EXTRAS))
def test_layer_matches_flax(name):
    x = np.random.default_rng(9).normal(0.3, 1, (3, 7, 6)).astype(np.float32)  # (N, T, C)
    tstack = _eval_and_train(EXTRAS[name], x)
    if name == "fc":
        assert isinstance(tstack.built_layers_0.prev_bn, tlayers.BatchNorm)


def test_gradx_scales_the_gradient_only():
    """Identity forward, the gradient times ``scale``, as JAX's
    x·s + stop_gradient(x·(1 − s))."""
    x = np.random.default_rng(10).normal(0, 1, (4, 5)).astype(np.float32)
    w = np.random.default_rng(11).normal(0, 1, (4, 5)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * jspec.layers.GradScaler(scale=-0.3)
                                      .apply({}, a)))(jnp.asarray(x))
    t = _t(x).requires_grad_(True)
    out = tlayers.GradScaler(-0.3)(t)
    assert torch.equal(out, _t(x))
    (out * _t(w)).sum().backward()
    assert float(np.abs(t.grad.numpy() - np.asarray(want)).max()) <= 1e-4 * np.abs(want).max()


def test_mul_noise_draws_from_the_dropout_generator():
    """Identity in eval; in training x · base^N(mean, std) with one draw per
    (batch, channel), the second half of the batch sharing the first half's,
    repeated by the same seed."""
    mod = tlayers.MultiplicativeNoise(base=2.0, mean=0.5, std=0.25)
    x = torch.rand(6, 3, 4, 5) + 0.5
    assert mod.eval()(x) is x
    mod.train()
    with pytest.raises(RuntimeError, match="generator"):
        mod(x)
    tlayers.set_dropout_generator(mod, torch.Generator().manual_seed(3))
    out = mod(x)
    expo = torch.log2(out / x)
    assert torch.allclose(expo, expo[:, :, :1, :1].expand_as(expo), atol=1e-5)
    assert torch.allclose(expo[:3], expo[3:], atol=1e-6)
    tlayers.set_dropout_generator(mod, torch.Generator().manual_seed(3))
    assert torch.equal(mod(x), out)
    big = tlayers.MultiplicativeNoise(base=2.0, mean=0.5, std=0.25).train()
    tlayers.set_dropout_generator(big, torch.Generator().manual_seed(4))
    draws = torch.log2(big(torch.ones(2, 20000)))[0]
    assert abs(float(draws.mean()) - 0.5) < 0.01 and abs(float(draws.std()) - 0.25) < 0.01


def test_prev_dropout_uses_the_layer_generator():
    fc = tlayers.FullyConnected(6, 4, prev_dropout=0.5, prev_drop_always=True)
    fc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.ones(8, 6)
    tlayers.set_dropout_generator(fc, torch.Generator().manual_seed(1))
    a = fc.eval()(x)
    tlayers.set_dropout_generator(fc, torch.Generator().manual_seed(1))
    assert torch.equal(fc(x), a)
    assert not torch.equal(a, x @ fc.weight() + fc.bias)  # dropped inputs, also in eval


PREFIXES = [
    [("permute", (0, 3, 2, 1)), ("conv2d", 3, 4, (3, 1), (1, 1)), ("identity",),
     ("gradx", 0.5), ("mul-noise",), ("freq-lstm", 4, 8, "hidden_size=4", "output_size=6"),
     ("squeeze", 2), ("fp", 6, 6), ("conv1d", 6, 6, 1), ("unsqueeze", 2),
     ("transpose", 1, 2), ("transpose", -1, -3), ("squeeze", 2), ("gru", 6, 4)],
    [("permute", (0, 3, 2, 1)), ("conv2d", 3, 4, (3, 1), (1, 1)), ("pool1d", "max", 2)],
    [("permute", (0, 3, 2, 1)), ("lstm2d", 3, 4)],
    [("flatten", 2), ("fc", 48, 6)],
    [("view", (2, 8, 48)), ("fc", 48, 6)],
    [("permute", (0, 3, 2, 1)), ("conv2d", 3, 4, (3, 1), (1, 1)), ("squeeze", 2),
     ("res1d", 4, 4, 1)],
    [("permute", (0, 3, 2, 1)), ("deconv2d", 3, 4, 1)],
    [("unsqueeze", 0), ("fc", 3, 3)],
    [("unsqueeze", -1), ("transpose", 1, 4), ("fp", 3, 3)],
    [("permute", (0, 3, 2, 1)), ("conv2d", 3, 4, (3, 1), (1, 1)), ("freq-lstm", 4, 8, "mode=last"),
     ("squeeze", 2), ("fp", 6, 6, "cat_condition=1")],
]


@pytest.mark.parametrize("case", range(len(PREFIXES)))
def test_prefix_split_follows_the_jax_rules(case):
    """A differing prefix/suffix split is a different result on the window
    path: every layer name gives the JAX split and time axis."""
    specs = PREFIXES[case]
    want = jspec.time_independent_prefix(jspec.parse_specs(specs, True))
    got = tspec.time_independent_prefix(tspec.parse_specs(specs, True))
    assert got == want
    if case == 0:
        assert got == (13, 1)
