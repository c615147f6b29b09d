"""The attention family beyond Bahdanau, port vs the JAX package on the same
weights (through the weight bridge) and numpy-seeded inputs at narrow widths:
ProdAttention and GmmAttention (softmax or scaled exponential weights, a
``scale_x`` of its own) built by ``create_self_atten`` from the spec keys, in
eval and training mode, through the shared query compression of ``_Attention``
at radius 1 and 3; the spec engine's query window picks the same rows.

Tolerance 1e-5 on contexts and alignments: f32 on both sides (JAX at
HIGHEST), sums in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_nn import _flax_vars, _stack_pair, _t

from sdfa_tpu.nn import attention as jatt
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.nn import attention as tatt

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL = 1e-5
KEYS = [("prod", 1, {}), ("prod", 3, {}), ("gmm", 1, dict(num_k=3)),
        ("gmm", 3, dict(num_k=2, softmax=True, scale_x=4.0)), ("bah", 3, dict(smooth=True))]


@pytest.mark.parametrize("name,radius,extra", KEYS,
                         ids=["prod-r1", "prod-r3", "gmm-r1", "gmm-softmax-r3", "bah-smooth-r3"])
def test_attention_matches_flax(name, radius, extra):
    rng = np.random.default_rng(7)
    key = rng.normal(0, 1, (3, 9, 6)).astype(np.float32)
    query = key[:, 4 - (radius - 1):4 + radius]
    jmod = jatt.create_self_atten(name, 6, 5, radius, **extra)
    tmod = tatt.create_self_atten(name, 6, 5, radius, **extra)
    assert type(tmod).__name__ == type(jmod).__name__
    variables = _flax_vars(jmod, jnp.asarray(query), jnp.asarray(key))
    load_flax_variables(tmod, variables)
    for training in (False, True):
        want_ctx, want_al = jmod.apply(variables, jnp.asarray(query), jnp.asarray(key),
                                       training=training)
        with torch.no_grad():
            got_ctx, got_al = tmod.train(training)(_t(query), _t(key))
        assert got_ctx.shape == (3, 1, 6) and got_al.shape == (3, 1, 9)
        assert float(np.abs(got_ctx.numpy() - np.asarray(want_ctx)).max()) < TOL
        assert float(np.abs(got_al.numpy() - np.asarray(want_al)).max()) < TOL


def test_unknown_attention_and_gmm_without_k_are_refused():
    with pytest.raises(NotImplementedError, match="not supported"):
        tatt.create_self_atten("mha", 6, 5, 1)
    with pytest.raises(ValueError, match="num_k"):
        tatt.create_self_atten("gmm", 6, 5, 1)


def test_attention_specs_in_a_stack_match_flax():
    """("attn", "gmm" / "prod", ...) in the spec engine: the centre window
    with ``query_offset``, the alignments captured under the stack's tag."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 7, 6)).astype(np.float32)
    specs = [("attn", "prod", 6, 4, 2, "query_offset=-1"),
             ("attn", "gmm", 6, 4, 1, "num_k=2")]
    for spec in specs:
        jstack, variables, tstack = _stack_pair([spec], x, weight_norm=True)
        want, want_al = jstack.apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got, got_al = tstack(_t(x))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL
        (ja,), (ta,) = want_al.values(), got_al.values()
        assert float(np.abs(ta.numpy() - np.asarray(ja)).max()) < TOL
