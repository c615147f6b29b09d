"""The biLSTM training core of the port (``sdfa_tpu_torch.ops.bilstm_core``)
against the JAX package (``sdfa_tpu.ops.pallas_bilstm_train``), on CPU:

- ``bilstm_core_plain`` vs ``bilstm_core_reference``, outputs and, through
  ``jax.grad``, the gradients for xp and w_hh;
- the ``autograd.Function``'s own forward and backward formulas (the
  plain-tensor transcription of the kernels' step, which CPU tensors take)
  vs autograd of the scan, and vs the Pallas kernels in interpret mode,
  residual layouts included;
- the CUDA kernels vs the plain version run on a card from
  tests_gpu/test_cuda_kernels.py (the kernels' cluster tiling is walked on
  the CPU in test_torch_core_tiled.py).

Budgets are those of tests/test_pallas_bilstm_train.py: out atol 2e-5,
gradients atol 3e-5 × max |gradient| (their sizes span ~4 orders through the
recurrence).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.ops import pallas_bilstm_train as J
from sdfa_tpu_torch.ops import bilstm_core as K5

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

SHAPES = [(3, 5, 128), (8, 10, 256)]  # (T, rows, H)


def _inputs(steps, rows, hid, seed=0):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((2, steps, rows, 4 * hid))).astype(np.float32)
    w_hh = (rng.standard_normal((2, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    dout = rng.standard_normal((steps, rows, 2 * hid)).astype(np.float32)
    return xp, w_hh, dout


def _torch_grads(fn, xp, w_hh, dout):
    txp = torch.from_numpy(xp).requires_grad_()
    tw = torch.from_numpy(w_hh).requires_grad_()
    out = fn(txp, tw)
    gx, gw = torch.autograd.grad(out, (txp, tw), torch.from_numpy(dout))
    return out.detach().numpy(), gx.numpy(), gw.numpy()


def _close(got, want, rel):
    scale = float(np.abs(want).max()) + 1e-12
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("steps,rows,hid", SHAPES)
def test_plain_forward_matches_reference(steps, rows, hid):
    xp, w_hh, _ = _inputs(steps, rows, hid)
    want = np.asarray(J.bilstm_core_reference(jnp.asarray(xp), jnp.asarray(w_hh)))
    got = K5.bilstm_core(torch.from_numpy(xp), torch.from_numpy(w_hh)).numpy()  # CPU → plain
    assert got.shape == (steps, rows, 2 * hid)
    assert float(np.abs(got - want).max()) < 2e-5


@pytest.mark.parametrize("steps,rows,hid", SHAPES)
def test_plain_gradients_match_jax_grad(steps, rows, hid):
    xp, w_hh, dout = _inputs(steps, rows, hid, seed=3)

    def loss(a, b):
        return jnp.sum(jnp.asarray(dout) * J.bilstm_core_reference(a, b))

    want_x, want_w = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(w_hh))
    _, got_x, got_w = _torch_grads(K5.bilstm_core_plain, xp, w_hh, dout)
    _close(got_x, np.asarray(want_x), 3e-5)
    _close(got_w, np.asarray(want_w), 3e-5)


@pytest.mark.parametrize("steps,rows,hid", SHAPES + [(1, 3, 128)])
def test_function_backward_matches_autograd_of_scan(steps, rows, hid):
    """BilstmCore on CPU tensors runs the kernels' step as plain tensors:
    its hand-written BPTT and the shifted dw_hh product against autograd."""
    xp, w_hh, dout = _inputs(steps, rows, hid, seed=5)
    want = _torch_grads(K5.bilstm_core_plain, xp, w_hh, dout)
    got = _torch_grads(K5.BilstmCore.apply, xp, w_hh, dout)
    assert float(np.abs(got[0] - want[0]).max()) < 2e-5
    _close(got[1], want[1], 3e-5)
    _close(got[2], want[2], 3e-5)


def test_function_needs_input_grad_and_no_double_backward():
    xp, w_hh, dout = _inputs(3, 4, 128, seed=6)
    txp, tw = torch.from_numpy(xp).requires_grad_(), torch.from_numpy(w_hh)
    out = K5.BilstmCore.apply(txp, tw)  # w_hh needs no gradient: none is computed
    (gx,) = torch.autograd.grad(out, (txp,), torch.from_numpy(dout), create_graph=True)
    assert gx.shape == txp.shape
    with pytest.raises(RuntimeError):
        gx.sum().backward()  # once_differentiable


def test_reverse_direction_indexing_with_distinct_steps():
    """T = 3 with a different scale per time step: a reverse-direction index
    slip (time order against direction-step order) cannot cancel out."""
    xp, w_hh, dout = _inputs(3, 2, 128, seed=7)
    xp *= np.asarray([0.2, 1.0, 3.0], np.float32)[None, :, None, None]
    dout *= np.asarray([2.0, 0.5, 1.0], np.float32)[:, None, None]
    want = _torch_grads(K5.bilstm_core_plain, xp, w_hh, dout)
    got = _torch_grads(K5.BilstmCore.apply, xp, w_hh, dout)
    for g, w in zip(got, want):
        _close(g, w, 3e-5)
    # direction 1 of the output at t = T−1 is its first step: h from xp[1, T−1] alone
    gates = xp[1, 2]
    i, g, o = (1 / (1 + np.exp(-gates[:, :128])), np.tanh(gates[:, 256:384]),
               1 / (1 + np.exp(-gates[:, 384:])))
    np.testing.assert_allclose(got[0][2, :, 128:], o * np.tanh(i * g), atol=1e-6)


@pytest.mark.parametrize("steps,rows,hid", [(4, 8, 128)])
def test_step_transcription_matches_pallas_interpret(steps, rows, hid):
    """The port's residuals are time-ordered; the Pallas kernels keep theirs
    in each direction's own step order, so direction 1 is flipped in time."""
    xp, w_hh, dout = _inputs(steps, rows, hid, seed=8)
    j_out, j_gates, j_c = J._fwd_impl(jnp.asarray(xp), jnp.asarray(w_hh), 256, True, 3)
    out, gates, cs = K5.forward_steps(torch.from_numpy(xp), torch.from_numpy(w_hh))
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < 2e-5
    for got, want in ((gates, j_gates), (cs, j_c)):
        want = np.asarray(want)
        assert float(np.abs(got[0].numpy() - want[0]).max()) < 2e-5
        assert float(np.abs(got[1].numpy() - want[1][::-1]).max()) < 2e-5
    w_hht = np.ascontiguousarray(np.swapaxes(w_hh, 1, 2))
    j_dg = np.asarray(J._bwd_impl(j_gates, j_c, jnp.asarray(w_hht), jnp.asarray(dout),
                                  256, True, 3))
    dg = K5.backward_steps(gates, cs, torch.from_numpy(w_hh), torch.from_numpy(dout)).numpy()
    _close(dg, j_dg, 3e-5)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """A width the kernels do not take raises before any build or launch."""
    with pytest.raises(ValueError):
        K5._core_dims(torch.zeros(2, 3, 4, 4 * 64))
    assert K5._core_dims(torch.zeros(2, 3, 4, 4 * 256)) == (3, 4, 256)
