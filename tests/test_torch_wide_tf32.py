"""The wide step loop in 3xTF32, walked on the CPU.

``csrc/bilstm_layer.cuh``'s wide step loop (H a multiple of 128 from 384 on:
K1, K2, K4 and K5's forward in ``wide_steps_kernel``, K5's backward in
``wide_bwd_kernel``) multiplies each step's h · w_hh (d_pre · w_hhᵀ) on the
tensor cores in 3xTF32. ``bilstm_layer.wide_steps_tiled`` and
``bilstm_core.wide_backward_steps_tiled`` repeat that arithmetic in plain
tensors: per wave of ``wide_wave_rows(H, capacity)`` rows, per block of
``WIDE_ROW_TILE`` rows x ``WIDE_UNITS`` units, the product split into TF32
parts, three products a k tile of ``WIDE_K`` (``tf32.tiled_product``), each
tile's sum added to the total in f32 as the kernels promote it. Here, at H =
384 and 512 with a few rows and short T (numpy-seeded inputs):

- the walks within 1e-6 of a float64 recurrence and backward (3xTF32 misses
  lo·lo, under 2^-22 of each product; the walks land 1.5e-7 from float64
  here, a plain f32 scan 2.5-3.4e-7);
- a step's pre-activations are the k-tile chain's bit for bit, and a row's
  outputs do not depend on the waves its launch is cut into;
- the 3xTF32 product at the steps' K (H, and 4H for the backward) sits at
  least 10 times closer to float64 than one TF32 pass;
- against the JAX package on the CPU: ``bilstm_layer_fused(interpret=True)``
  for a layer and ``pallas_bilstm_train.bilstm_core(interpret=True)`` with
  ``jax.grad`` for the training core, within 5e-5 (the budget the JAX
  package's own Pallas kernels are held to, gradients over the largest).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.ops import pallas_bilstm_train as J5
from sdfa_tpu.ops.pallas_bilstm import bilstm_layer_fused
from sdfa_tpu_torch.ops import bilstm_core as K5
from sdfa_tpu_torch.ops import bilstm_layer as K4
from sdfa_tpu_torch.ops.tf32 import round_tf32, tiled_product

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

F64_TOL = 1e-6     # a walk against float64: absolute for h, c, gates; over the largest for dg
ONE_PASS_GAP = 10  # one TF32 pass is at least this many times further from float64
TOL_JAX = 5e-5     # a walk against the JAX Pallas kernels in interpret mode


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _layer(rng, rows, steps, hid):
    return [torch.from_numpy(a) for a in (
        _rand(rng, (rows, steps, hid), 0.5), _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
        _rand(rng, (2, hid, 4 * hid), hid ** -0.5), _rand(rng, (2, 4 * hid), 0.1))]


def _core(rng, steps, rows, hid):
    return [torch.from_numpy(a) for a in (
        _rand(rng, (2, steps, rows, 4 * hid), 0.5), _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
        _rand(rng, (steps, rows, 2 * hid), 1.0))]


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("hid,rows,steps,capacity", [
    (384, 70, 3, None),   # two row tiles of 64, the second of 6 rows
    (384, 70, 3, 48),     # one row tile a wave: two waves
    (512, 9, 4, None)])
def test_layer_walk_within_1e6_of_float64(hid, rows, steps, capacity):
    """K4's chunk (the projection in 3xTF32, then the wide step loop) against
    the float64 layer."""
    args = _layer(np.random.default_rng(hid + rows), rows, steps, hid)
    got = K4.bilstm_layer_tiled(*args, capacity=capacity)
    want = K4.bilstm_layer_plain(*(a.double() for a in args))
    assert float((got.double() - want).abs().max()) < F64_TOL


@pytest.mark.parametrize("hid,steps,rows,capacity", [(384, 3, 70, None), (512, 2, 9, 64)])
def test_core_walks_within_1e6_of_float64(hid, steps, rows, capacity):
    """K5's wide forward (h, the gates, c) and backward (d(xp), from the
    float64 residuals rounded to f32) against the float64 step and BPTT."""
    xp, w_hh, dout = _core(np.random.default_rng(2 * hid + rows), steps, rows, hid)
    out, gates, cs = K5.forward_steps_tiled(xp, w_hh, capacity=capacity)
    want = K5.forward_steps(xp.double(), w_hh.double())
    for got, exact in zip((out, gates, cs), want):
        assert float((got.double() - exact).abs().max()) < F64_TOL
    dg = K5.wide_backward_steps_tiled(want[1].float(), want[2].float(), w_hh, dout, capacity)
    exact = K5.backward_steps(*(a.double() for a in (want[1].float(), want[2].float(), w_hh,
                                                      dout)))
    assert _rel(dg, exact) < F64_TOL


def test_step_is_the_k_tile_chain():
    """The forward walk's second step, for one block (the first row tile, the
    first run of units of direction 0): its gates are the cell of tiled_product
    (h of step 0, the block's w_hh columns, k tiles of WIDE_K) + xp, bit for
    bit; the backward's next-to-last d_pre likewise from the last one's."""
    xp, w_hh, dout = _core(np.random.default_rng(5), 2, 5, 384)
    out, gates, cs = K5.forward_steps_tiled(xp, w_hh)
    cols = K4.wide_run_columns(384)[0]
    pre = (tiled_product(out[0, :, :384], w_hh[0][:, cols], K4.WIDE_K)
           + xp[0, 1][:, cols]).reshape(5, 4, K4.WIDE_UNITS)
    act = torch.cat([torch.sigmoid(pre[:, 0]), torch.sigmoid(pre[:, 1]), torch.tanh(pre[:, 2]),
                     torch.sigmoid(pre[:, 3])], dim=-1)
    assert torch.equal(gates[0, 1][:, cols], act)
    dg = K5.wide_backward_steps_tiled(gates, cs, w_hh, dout)
    units = slice(0, K4.WIDE_UNITS)
    zero = torch.zeros(5, K4.WIDE_UNITS)
    i, f, g, o = gates[0, 1][:, cols].reshape(5, 4, K4.WIDE_UNITS).unbind(1)
    _, dc = K5._d_pre(i, f, g, o, cs[0, 1, :, units], cs[0, 0, :, units], dout[1, :, units],
                      zero)  # step 1, processed first: no dh, no dc yet
    dh = tiled_product(dg[0, 1], w_hh[0, units].T, K4.WIDE_K)
    i, f, g, o = gates[0, 0][:, cols].reshape(5, 4, K4.WIDE_UNITS).unbind(1)
    d_pre, _ = K5._d_pre(i, f, g, o, cs[0, 0, :, units], zero, dout[0, :, units] + dh, dc)
    assert torch.equal(dg[0, 0][:, cols], d_pre.transpose(1, 2).reshape(5, -1))


@pytest.mark.parametrize("capacity", [48, 96, 144])
def test_waves_do_not_change_a_row(capacity):
    """130 rows at H = 384 in waves of one, two or three row tiles of 64 give
    the bits of one wave: a row's arithmetic is its own, the waves only order
    the launches."""
    xp, w_hh, dout = _core(np.random.default_rng(9), 2, 130, 384)
    one = K5.forward_steps_tiled(xp, w_hh)
    cut = K5.forward_steps_tiled(xp, w_hh, capacity=capacity)
    assert all(torch.equal(a, b) for a, b in zip(one, cut))
    assert torch.equal(K5.wide_backward_steps_tiled(*one[1:], w_hh, dout),
                       K5.wide_backward_steps_tiled(*one[1:], w_hh, dout, capacity))


@pytest.mark.parametrize("k", [384, 512, 1536, 2048])
def test_three_passes_beat_one_at_the_steps_k(k):
    """h · w_hh (K = H) and d_pre · w_hhᵀ (K = 4H) in 3xTF32 at k tiles of
    WIDE_K, against float64 and against one TF32 pass."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(_rand(rng, (64, k), 0.5))
    b = torch.from_numpy(_rand(rng, (k, 64), k ** -0.5))
    exact = a.double() @ b.double()
    three = float((tiled_product(a, b, K4.WIDE_K).double() - exact).abs().max())
    one = float(((round_tf32(a) @ round_tf32(b)).double() - exact).abs().max())
    assert three * ONE_PASS_GAP < one
    assert three < F64_TOL * float(exact.abs().max())


@pytest.mark.parametrize("hid", [384, 512])
def test_layer_walk_matches_pallas_interpret(hid):
    """K4 at H = 384 and 512 (8 rows, the JAX kernel's block) against the
    JAX ``bilstm_layer_fused`` in interpret mode."""
    args = _layer(np.random.default_rng(30 + hid), 8, 3, hid)
    want = np.asarray(bilstm_layer_fused(*(jnp.asarray(a.numpy()) for a in args),
                                         block_rows=8, interpret=True))
    got = K4.bilstm_layer_tiled(*args).numpy()
    assert float(np.abs(got - want).max()) < TOL_JAX


@pytest.mark.parametrize("hid", [384, 512])
def test_core_walks_match_pallas_interpret(hid):
    """K5 at H = 384 and 512: the walks' forward and d(xp) against
    ``bilstm_core(interpret=True)`` and ``jax.grad`` of it."""
    xp, w_hh, dout = _core(np.random.default_rng(40 + hid), 2, 3, hid)
    jxp, jw = jnp.asarray(xp.numpy()), jnp.asarray(w_hh.numpy())

    def loss(a):
        return jnp.sum(jnp.asarray(dout.numpy()) * J5.bilstm_core(a, jw, block_rows=8,
                                                                interpret=True))

    want_out = np.asarray(J5.bilstm_core(jxp, jw, block_rows=8, interpret=True))
    want_dx = np.asarray(jax.grad(loss)(jxp))
    out, gates, cs = K5.forward_steps_tiled(xp, w_hh)
    assert float(np.abs(out.numpy() - want_out).max()) < TOL_JAX
    dg = K5.wide_backward_steps_tiled(gates, cs, w_hh, dout).numpy()
    assert float(np.abs(dg - want_dx).max() / np.abs(want_dx).max()) < TOL_JAX
