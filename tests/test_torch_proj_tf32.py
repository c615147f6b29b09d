"""The recurrent kernels' input projection in 3xTF32, on the CPU.

``bilstm_layer.projection_tiled`` is the projection the way
``csrc/bilstm_layer.cuh::proj_kernel`` computes it on the tensor cores: x and
w_ih split into two TF32 parts each, the three products hi·hi, hi·lo, lo·hi
summed k tile by k tile, the gate bias last. Here, at narrow rows and the
input widths the shipped and wide models give it (64: FreqLstm; 256, 512:
the time stack; 768, 1024: the wide stacks' deeper layers) and two that are
no multiple of the k tile (67, 100):

- it sits within 1e-5 of the row's largest |xp| from a float64 product;
- one TF32 pass (both operands rounded once) sits at least 10 times further
  from float64, which is why the kernel takes three;
- the gate bias is added last, after the products;
- a narrow K4 / K2 chunk through ``layer_tiled_chunk`` with this projection
  stays within the existing budgets of the JAX ``bilstm_layer_fused`` (Pallas
  in interpret mode, 5e-5) and ``bilstm_2layer_reference`` (the scan the JAX
  tests hold its kernel to, 1e-5), and ``projection`` takes
  ``projection_tiled`` for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops.pallas_bilstm import bilstm_layer_fused, bilstm_layer_reference
from sdfa_tpu.ops.pallas_bilstm2 import bilstm_2layer_reference
from sdfa_tpu_torch.ops import bilstm2 as K2
from sdfa_tpu_torch.ops import bilstm_layer as K4
from sdfa_tpu_torch.ops.tf32 import round_tf32, split_tf32

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

F64_REL = 1e-5     # 3xTF32 against float64, over the row's largest |xp|
ONE_PASS_GAP = 10  # one TF32 pass is at least this many times further from float64
TOL = 1e-5         # a chunk against the scan reference, f32 sums in another order
TOL_JAX = 5e-5     # a chunk against the JAX Pallas kernel in interpret mode


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _projection_inputs(n_in, gdim=512, rows=3, steps=8, seed=0):
    rng = np.random.default_rng(seed + n_in)
    return (torch.from_numpy(_rand(rng, (rows, steps, n_in), 1.0)),
            torch.from_numpy(_rand(rng, (2, n_in, gdim), n_in ** -0.5)),
            torch.from_numpy(_rand(rng, (2, gdim), 0.1)))


def _f64(x, w_ih, gb):
    want = torch.stack([x.double() @ w_ih[d].double() for d in range(2)])
    return want if gb is None else want + gb.double()[:, None, None]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n_in", [64, 256, 512, 768, 1024, 67, 100])
def test_three_passes_within_1e5_of_float64(n_in, bias):
    x, w_ih, gb = _projection_inputs(n_in)
    gb = gb if bias else None
    exact = _f64(x, w_ih, gb)
    got = K4.projection_tiled(x, w_ih, gb)
    assert got.shape == (2, 3, 8, 512) and got.dtype == torch.float32
    scale = float(exact.abs().max())
    err3 = float((got.double() - exact).abs().max())
    assert err3 <= F64_REL * scale
    # one pass: both operands rounded to TF32 once, as the tensor cores would take them
    one = torch.stack([round_tf32(x) @ round_tf32(w_ih[d]) for d in range(2)])
    one = one if gb is None else one + gb[:, None, None]
    err1 = float((one.double() - exact).abs().max())
    assert err1 >= ONE_PASS_GAP * err3, (err1, err3)


def test_split_parts_are_tf32_and_keep_22_bits():
    """hi and lo have their 13 low bits zero; hi + lo is within 2^-21 of x
    relative to |x|."""
    x = torch.from_numpy(_rand(np.random.default_rng(3), (4096,), 1.0))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


def test_bias_added_last():
    """The bias is added once, after every k tile's products: with it, the
    projection is the one without it plus the bias, bit for bit."""
    x, w_ih, gb = _projection_inputs(100, seed=5)
    with_bias = K4.projection_tiled(x, w_ih, gb)
    assert torch.equal(with_bias, K4.projection_tiled(x, w_ih, None) + gb[:, None, None])


def test_projection_takes_the_plain_version_on_the_cpu():
    x, w_ih, gb = _projection_inputs(256, seed=7)
    assert torch.equal(K4.projection(x, w_ih, gb), K4.projection_tiled(x, w_ih, gb))


def test_scratch_pads_x_only_where_16_byte_copies_cannot_read_it():
    """w_ih staged (2, 8H, K padded to PROJ_K) for each layer; the padded copy
    of x only for an input width that is no multiple of 4 or an x that is not
    16-byte aligned."""
    x = torch.zeros(2, 3, 64)
    (wt,), xpad = K4.proj_scratch(x, 64, 128, 6)
    assert wt.shape == (2, 1024, 64) and xpad is None
    x = torch.zeros(2, 3, 67)
    (wt1, wt2), xpad = K4.proj_scratch(x, 67, 128, 6, w_ih_inputs=(256,))
    assert (wt1.shape, wt2.shape, xpad.shape) == ((2, 1024, 96), (2, 1024, 256), (6, 68))
    offset = torch.zeros(2 * 3 * 64 + 1)[1:].view(2, 3, 64)  # 4 bytes past an aligned start
    assert K4.proj_needs_pad(offset) and not K4.proj_needs_pad(torch.zeros(2, 3, 64))


def _weights(rng, n_in, hid, bias=True):
    return [_rand(rng, (2, n_in, 4 * hid), n_in ** -0.5), _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
            _rand(rng, (2, 4 * hid), 0.1) if bias else None]


def _both(args):
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("hid,n_in", [(128, 64), (256, 100)])
def test_k4_chunk_with_the_projection_against_the_fused_kernel(hid, n_in):
    """A K4 chunk (7 rows, T = 3) through ``layer_tiled_chunk``, its
    projection in 3xTF32, against the JAX Pallas kernel in interpret mode
    and the scan reference."""
    rng = np.random.default_rng(hid + n_in)
    jx, tx = _both([_rand(rng, (7, 3, n_in), 1.0)] + _weights(rng, n_in, hid))
    got = K4.layer_tiled_chunk(*tx).numpy()
    assert got.shape == (7, 3, 2 * hid)
    assert np.abs(got - np.asarray(bilstm_layer_reference(*jx))).max() < TOL
    want = bilstm_layer_fused(*jx, block_rows=8, interpret=True)
    assert np.abs(got - np.asarray(want)).max() < TOL_JAX


@pytest.mark.parametrize("hid,n_in", [(128, 64), (256, 256)])
def test_k2_chunk_with_the_projection_against_the_reference(hid, n_in):
    """A K2 chunk (5 rows, T = 2): both layers' projections in 3xTF32, against
    ``bilstm_2layer_reference``."""
    rng = np.random.default_rng(2 * hid + n_in)
    args = ([_rand(rng, (5, 2, n_in), 1.0)] + _weights(rng, n_in, hid)
            + _weights(rng, 2 * hid, hid, bias=False))
    jx, tx = _both(args)
    got = K2.bilstm2_tiled(*tx).numpy()
    assert got.shape == (5, 2, 2 * hid)
    assert np.abs(got - np.asarray(bilstm_2layer_reference(*jx))).max() < TOL
