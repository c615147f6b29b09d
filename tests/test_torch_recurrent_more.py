"""The recurrent layers the shipped configs do not use, port vs the JAX
package on the same weights (through the weight bridge) and numpy-seeded
inputs at narrow widths: the one-directional LSTM, the GRU (both
directions), FreqLstm "last" (4-D and 3-D inputs) and LSTM2d, each in eval
mode and in training mode with its parameter gradients (dropout 0: the
frameworks' random streams differ). The cuDNN route of the one-directional
LSTM and the GRU (``library_layer``, ``torch._VF``) runs here on the CPU
against the plain step loop, which holds its weight layout.

Tolerances: outputs 1e-5 (f32 on both sides, JAX at HIGHEST, sums in another
order); gradients 1e-4 of the largest gradient of each parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_nn import _flax_vars, _t

from sdfa_tpu.nn import recurrent as jrec
from sdfa_tpu_torch.compat import load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.nn import recurrent as trec

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 1e-5
GRAD_TOL = 1e-4


def _pair(jmod, tmod, x):
    """Eval-mode outputs, then training-mode outputs and the gradients of
    Σ w·out, on both sides: [(want, got, grads_want, grads_got)] × 2."""
    variables = _flax_vars(jmod, jnp.asarray(x))
    load_flax_variables(tmod, variables)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = tmod.eval()(_t(x)).numpy()
    w_out = np.random.default_rng(99).normal(0, 1, want.shape).astype(np.float32)

    def jloss(params):
        out = jmod.apply({**variables, "params": params}, jnp.asarray(x), True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(jnp.asarray(w_out) * out), out

    (_, twant), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    tgot = tmod.train()(_t(x))
    (tgot * _t(w_out)).sum().backward()
    grads_want = state_dict_from_flax({"params": jax.device_get(jgrads)})
    grads_got = {n: p.grad for n, p in tmod.named_parameters()}
    assert sorted(grads_got) == sorted(grads_want)
    return [(want, got, None, None),
            (np.asarray(twant), tgot.detach().numpy(), grads_want, grads_got)]


def _check(want, got, grads_want, grads_got):
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) < TOL
    for name, w in (grads_want or {}).items():
        scale = float(w.abs().max()) + 1e-12
        assert float((grads_got[name] - w).abs().max()) <= GRAD_TOL * scale, name


CASES = [("lstm", 1, True), ("lstm", 1, False), ("gru", 1, False), ("gru", 2, True)]


@pytest.mark.parametrize("kind,dirs,bias", CASES)
def test_lstm_gru_match_flax(kind, dirs, bias):
    """2-layer stacks: a one-directional LSTM, a GRU each way."""
    x = np.random.default_rng(4).normal(0, 1, (3, 7, 5)).astype(np.float32)
    jcls, tcls = (jrec.LSTM, trec.LSTM) if kind == "lstm" else (jrec.GRU, trec.GRU)
    jmod = jcls(input_size=5, hidden_size=6, num_layers=2, bias=bias, bidirectional=dirs == 2)
    tmod = tcls(5, 6, num_layers=2, bias=bias, bidirectional=dirs == 2)
    for case in _pair(jmod, tmod, x):
        _check(*case)


@pytest.mark.parametrize("kind,dirs,bias", CASES)
def test_library_layer_matches_plain_loop(kind, dirs, bias):
    """``torch._VF`` (cuDNN's layout on a card) against the step loop, output
    and gradients, on the same weights: the JAX (in, gates·H) weights reach it
    transposed, in its gate order."""
    tcls = trec.LSTM if kind == "lstm" else trec.GRU
    mod = tcls(5, 6, num_layers=1, bias=bias, bidirectional=dirs == 2)
    mod.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(4))
    outs, grads = [], []
    for fn in (mod.plain_layer, mod.library_layer):
        mod.zero_grad()
        out = fn(x, 0)
        out.pow(2).sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in mod.named_parameters()})
    assert outs[0].shape == (3, 7, 6 * dirs)
    assert float((outs[0] - outs[1]).abs().max()) < TOL
    for name, g in grads[0].items():
        assert float((grads[1][name] - g).abs().max()) <= GRAD_TOL * float(g.abs().max()), name


@pytest.mark.parametrize("dim4", [True, False], ids=["4d", "3d"])
def test_freq_lstm_last_matches_flax(dim4):
    """The forward direction's last step and the reverse direction's first,
    projected from 2H."""
    shape = (2, 5, 6, 4) if dim4 else (3, 5, 6)
    x = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    jmod = jrec.FreqLstm(input_size=5, freq_length=6, hidden_size=8, output_size=7, mode="last")
    tmod = trec.FreqLstm(5, 6, hidden_size=8, output_size=7, mode="last")
    assert tmod.proj.in_channels == 16
    for case in _pair(jmod, tmod, x):
        assert case[1].shape == ((2, 7, 1, 4) if dim4 else (3, 7, 1))
        _check(*case)


@pytest.mark.parametrize("layers,bias", [(2, True), (3, False)])
def test_lstm2d_matches_flax(layers, bias):
    """Frequency then time (then frequency again), residuals where the shape
    holds; ``lstm_{k}`` bridge by name."""
    x = np.random.default_rng(6).normal(0, 1, (2, 4, 5, 6)).astype(np.float32)  # (B, C, F, T)
    jmod = jrec.LSTM2d(input_size=4, hidden_size=3, num_layers=layers, bias=bias)
    tmod = trec.LSTM2d(4, 3, num_layers=layers, bias=bias)
    for case in _pair(jmod, tmod, x):
        assert case[1].shape == (2, 6, 5, 6)
        _check(*case)
