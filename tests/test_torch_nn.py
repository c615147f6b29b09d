"""Layer parity: sdfa_tpu_torch.nn vs the flax modules of sdfa_tpu.nn on the
same parameters (moved across with the weight bridge), at narrow widths.

Parameters are perturbed away from their init before both sides see them,
so weight norm (g ≠ ‖v‖), biases and BatchNorm statistics all matter.
Tolerance: 2e-5 — f32 on both sides (JAX at HIGHEST), sums in another
order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.nn import LayerStack as JStack
from sdfa_tpu.nn import freeze_specs
from sdfa_tpu.nn import recurrent as jrec
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.nn import recurrent as trec
from sdfa_tpu_torch.nn.spec import LayerStack as TStack
from sdfa_tpu_torch.nn.spec import encoder_overlap_split

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 2e-5
BN = "batch_norm={'momentum': 0.01, 'eps': 0.001}"
LRELU = "act=lrelu@a:0.2"
# the shipped encoder's layer types at narrow widths (configs/_shared.py)
ENCODER = [
    ("permute", (0, 3, 2, 1)),
    ("conv2d", 3, 4, (3, 1), (1, 1), LRELU, BN),
    ("pool2d", "max", (2, 1)),
    ("conv2d", 4, 6, (1, 1), (1, 1), LRELU, BN),
    ("freq-lstm", 6, 8, "hidden_size=16", "output_size=12"),
    ("squeeze", 2),
    ("permute", (0, 2, 1)),
    ("lstm", 12, 16, "num_layers=2", "bidirectional=True", "dropout=0.1"),
    ("attn", "bah", 32, 8, 2, "scale_score_at_eval=1.0"),
]
HEADS = [
    ("fc", 32 + 4, 16, LRELU, "cat_condition=2"),
    ("fc", 16, 8, "act=tanh"),
    ("fc", 8, 5, "act=linear"),
]
CROP = [("conv2d", 3, 5, (3, 3), (2, 2), BN, "act=tanh")]  # stride 2 on odd sizes


def _perturb(tree, rng):
    """Move every leaf off its init value (numpy tree)."""
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = _perturb(val, rng)
            continue
        val = np.asarray(val, np.float32)
        if key in ("kernel_g", "scale", "var"):
            val = val * rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key in ("bias", "b", "mean") or key.startswith(("b_ih", "b_hh")):
            val = val + rng.normal(0, 0.1, val.shape).astype(np.float32)
        out[key] = val
    return out


def _flax_vars(module, *args, seed=0):
    k = jax.random.PRNGKey(seed)
    variables = jax.device_get(module.init({"params": k, "dropout": k}, *args))
    return _perturb(variables, np.random.default_rng(seed))


def _stack_pair(specs, x, cond=None, weight_norm=True):
    jstack = JStack(specs=freeze_specs(specs), weight_norm=weight_norm, tag="t")
    variables = _flax_vars(jstack, jnp.asarray(x), None if cond is None else jnp.asarray(cond))
    tstack = load_flax_variables(TStack(specs, weight_norm, tag="t"), variables)
    return jstack, variables, tstack.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(1).normal(0.4, 0.2, (2, 10, 16, 3)).astype(np.float32)


def test_encoder_stack_matches_flax(feats):
    """conv2d + BN + lrelu, max-pool, FreqLstm, squeeze/permute, 2-layer
    biLSTM and Bahdanau attention, end to end."""
    jstack, variables, tstack = _stack_pair(ENCODER, feats)
    want, want_al = jstack.apply(variables, jnp.asarray(feats))
    with torch.no_grad():
        got, got_al = tstack(_t(feats))
    assert got.shape == want.shape == (2, 1, 32)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL
    (ja,), (ta,) = want_al.values(), got_al.values()
    assert float(np.abs(ta.numpy() - np.asarray(ja)).max()) < TOL


def test_heads_with_cat_condition_match_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 1, 32)).astype(np.float32)
    cond = np.eye(4, dtype=np.float32)[[0, 3, 1]]
    jstack, variables, tstack = _stack_pair(HEADS, x, cond)
    want, _ = jstack.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    with torch.no_grad():
        got, _ = tstack(_t(x), _t(cond))
    assert got.shape == (3, 1, 5)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


def test_strided_conv_crop_matches_flax():
    """Negative "same" padding (stride 2 on odd sizes) crops like F.pad."""
    x = np.random.default_rng(3).normal(0, 1, (2, 3, 15, 9)).astype(np.float32)
    jstack, variables, tstack = _stack_pair(CROP, x)
    want, _ = jstack.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tstack(_t(x))
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


def test_start_stop_split_matches_flax(feats):
    """The overlap path's split: prefix [0:split) then suffix [split:) equals
    the full stack, and the prefix output matches flax's subrange call."""
    split, taxis = encoder_overlap_split(ENCODER, True)
    assert (split, taxis) == (7, 1)
    jstack, variables, tstack = _stack_pair(ENCODER, feats)
    want_prefix, _ = jstack.apply(variables, jnp.asarray(feats), stop=split)
    with torch.no_grad():
        prefix, _ = tstack(_t(feats), stop=split)
        suffix, _ = tstack(prefix, start=split)
        full, _ = tstack(_t(feats))
    assert float(np.abs(prefix.numpy() - np.asarray(want_prefix)).max()) < TOL
    torch.testing.assert_close(suffix, full, rtol=0, atol=0)


@pytest.mark.parametrize("num_layers,bias", [(1, True), (2, False), (2, True)])
def test_lstm_matches_flax(num_layers, bias):
    x = np.random.default_rng(4).normal(0, 1, (3, 7, 12)).astype(np.float32)
    jmod = jrec.LSTM(input_size=12, hidden_size=16, num_layers=num_layers, bias=bias,
                     bidirectional=True)
    variables = _flax_vars(jmod, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = trec.LSTM(12, 16, num_layers=num_layers, bias=bias, bidirectional=True)
    load_flax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.shape == (3, 7, 32)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


def test_freq_lstm_matches_flax():
    x = np.random.default_rng(5).normal(0, 1, (2, 8, 6, 5)).astype(np.float32)  # (B, C, F, T)
    jmod = jrec.FreqLstm(input_size=8, freq_length=6, hidden_size=16, output_size=12)
    variables = _flax_vars(jmod, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = load_flax_variables(trec.FreqLstm(8, 6, hidden_size=16, output_size=12), variables)
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.shape == (2, 12, 1, 5)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL


def test_lstm_keeps_stacked_weights_in_eval_mode_only():
    """In eval mode with autograd off ``layer_weights`` hands out the tensors
    it stacked before, bit-equal to a fresh stack; ``load_state_dict``, an
    in-place write, ``.to()`` of another dtype and ``train()`` each drop them,
    and training (or autograd on) never keeps any: the stack stays in the
    graph."""
    lstm = trec.LSTM(6, 4, num_layers=2, bias=True, bidirectional=True)
    lstm.reset_parameters(torch.Generator().manual_seed(0))
    lstm.eval()

    def fresh(layer):
        sfx = (f"_l{layer}", f"_l{layer}_reverse")
        return (torch.stack([getattr(lstm, "w_ih" + s) for s in sfx]),
                torch.stack([getattr(lstm, "w_hh" + s) for s in sfx]),
                torch.stack([getattr(lstm, "b_ih" + s) + getattr(lstm, "b_hh" + s) for s in sfx]))

    with torch.inference_mode():
        first = lstm.layer_weights(1)
        assert all(a is b for a, b in zip(first, lstm.layer_weights(1)))
        assert all(torch.equal(a, b) for a, b in zip(first, fresh(1)))
        x = torch.randn(3, 5, 6, generator=torch.Generator().manual_seed(1))
        out = lstm(x)
        lstm._stacked.clear()
        assert torch.equal(out, lstm(x))  # kept or restacked: the same bits

    state = {k: v + 1.0 for k, v in lstm.state_dict().items()}
    lstm.load_state_dict(state)
    with torch.inference_mode():
        reloaded = lstm.layer_weights(1)
        assert reloaded[0] is not first[0]
        assert all(torch.equal(a, b) for a, b in zip(reloaded, fresh(1)))
    with torch.no_grad():
        lstm.w_hh_l1.mul_(2.0)  # what an optimizer step does
        assert torch.equal(lstm.layer_weights(1)[1], fresh(1)[1])
        kept = lstm.layer_weights(0)
        lstm.double()
        assert lstm.layer_weights(0)[0].dtype == torch.float64 and kept[0].dtype == torch.float32
        lstm.float()
    assert lstm.layer_weights(0)[0].requires_grad  # autograd on: nothing kept, in the graph
    assert not lstm._stacked
    lstm.train()
    with torch.no_grad():
        lstm.layer_weights(0)
    assert not lstm._stacked
