"""FreqLstm's output projection in 3xTF32, on the CPU.

``freq_lstm.output_projection_tiled`` is the output projection the way
``csrc/freq_lstm.cu::out_parts_kernel`` + ``out_sum_kernel`` compute it on the
tensor cores: K = F·2H in slabs of ``K_SLAB``, each slab's partial sum k tile
by k tile of ``OUT_K`` as three TF32 products (h and w_proj split into hi and
lo parts: hi·hi, hi·lo, lo·hi), the slabs added in slab order, the bias last.
Here, at narrow rows and the K the shipped and wide models give it (8192: H
128, F 32; 16384, 24576, 32768: H 256, 384, 512):

- it sits within 1e-5 of the largest |out| from a float64 product;
- one TF32 pass (both operands rounded once) sits at least 10 times further
  from float64, which is why the kernel takes three;
- the bias is added last, and the slabs are added in one fixed order;
- ``freq_lstm_tiled`` at the shipped F = 32 stays within 1e-5 of
  ``freq_lstm_plain`` and within 5e-5 of the JAX ``freq_lstm_reference`` and
  of ``freq_lstm_fused`` (Pallas in interpret mode), and ``output_projection``
  takes the plain walk for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops.pallas_freq_lstm import freq_lstm_fused, freq_lstm_reference
from sdfa_tpu_torch.ops import freq_lstm as K1
from sdfa_tpu_torch.ops.tf32 import round_tf32, tiled_product

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

F64_REL = 1e-5     # 3xTF32 against float64, over the largest |out|
ONE_PASS_GAP = 10  # one TF32 pass is at least this many times further from float64
TOL_PLAIN = 1e-5   # freq_lstm_tiled against the plain version: f32 sums in another order
TOL_JAX = 5e-5     # against the JAX package, the repo's forward budget


def _operands(k, out, rows=3, seed=0):
    """h as the step loop leaves it (|h| < 1), w_proj and b_proj at the scales
    of the kernel phase's seeded weights."""
    rng = np.random.default_rng(seed + k + out)
    return (torch.from_numpy(rng.uniform(-1, 1, (rows, k)).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 0.02, (k, out)).astype(np.float32)),
            torch.from_numpy(rng.normal(0, 0.1, (out,)).astype(np.float32)))


@pytest.mark.parametrize("k,out", [(8192, 256), (16384, 512), (24576, 384), (32768, 512)])
def test_slab_walk_within_1e5_of_float64(k, out):
    h, w, b = _operands(k, out)
    exact = h.double() @ w.double() + b.double()
    got = K1.output_projection_tiled(h, w, b)
    assert got.shape == (3, out) and got.dtype == torch.float32
    scale = float(exact.abs().max())
    err3 = float((got.double() - exact).abs().max())
    assert err3 <= F64_REL * scale
    # one pass: both operands rounded to TF32 once, as the tensor cores would take them
    one = round_tf32(h) @ round_tf32(w) + b
    err1 = float((one.double() - exact).abs().max())
    assert err1 >= ONE_PASS_GAP * err3, (err1, err3)


def test_bias_added_last():
    """The bias is added once, after the last slab: with it, the projection is
    the one without it plus the bias, bit for bit."""
    h, w, b = _operands(1280, 201, rows=5)
    assert torch.equal(K1.output_projection_tiled(h, w, b),
                       K1.output_projection_tiled(h, w, None) + b)


def test_slabs_added_in_slab_order():
    """K = 1280 is slabs of 512, 512 and 256: the walk is the chain of their
    3xTF32 partial sums from the first slab to the last, bit for bit; another
    order gives other bits, within 1e-5."""
    h, w, b = _operands(1280, 256, rows=4, seed=1)
    parts = [tiled_product(h[:, k:k + K1.K_SLAB], w[k:k + K1.K_SLAB], K1.OUT_K)
             for k in (0, 512, 1024)]
    want = ((parts[0] + parts[1]) + parts[2]) + b
    got = K1.output_projection_tiled(h, w, b)
    assert torch.equal(got, want)
    other = K1.output_projection_tiled(h, w, b, slab_order=[2, 1, 0])
    assert not torch.equal(other, got)
    assert float((other - got).abs().max()) < 1e-5


def test_k_tiles_split_a_slab():
    """Within a slab the products are summed k tile by k tile of OUT_K: a
    slab's partial sum is the chain of its tiles' three products."""
    h, w, _ = _operands(512, 128, rows=2, seed=2)
    hi_h, lo_h = round_tf32(h), round_tf32(h - round_tf32(h))
    hi_w, lo_w = round_tf32(w), round_tf32(w - round_tf32(w))
    chain = None
    for k in range(0, 512, K1.OUT_K):
        ks = slice(k, k + K1.OUT_K)
        term = hi_h[:, ks] @ hi_w[ks] + hi_h[:, ks] @ lo_w[ks] + lo_h[:, ks] @ hi_w[ks]
        chain = term if chain is None else chain + term
    assert torch.equal(K1.output_projection_tiled(h, w, None), chain)


def test_output_projection_takes_the_plain_walk_on_the_cpu():
    h, w, b = _operands(1024, 256, rows=6, seed=3)
    assert torch.equal(K1.output_projection(h, w, b), K1.output_projection_tiled(h, w, b))
    assert torch.equal(K1.output_projection(h, w, None), K1.output_projection_tiled(h, w, None))


def _freq_args(seed, rows, n_freq, n_in, hid, out):
    rng = np.random.default_rng(seed)

    def rand(shape, scale):
        return rng.normal(0, scale, shape).astype(np.float32)

    return [rand((rows, n_freq, n_in), 1.0), rand((2, n_in, 4 * hid), 0.1),
            rand((2, hid, 4 * hid), 0.1), rand((2, 4 * hid), 0.1),
            rand((n_freq * 2 * hid, out), 0.02), rand((out,), 0.1)]


@pytest.mark.parametrize("hid,out", [(128, 256), (256, 512)])
def test_freq_lstm_tiled_at_32_steps_against_plain_and_jax(hid, out):
    """FreqLstm at the shipped 32 frequency steps (K = 8192, and 16384 at H =
    256), 3 rows of a narrow input: the tiled walk with its 3xTF32 output
    projection against the plain version and the JAX scan reference; at H =
    128 also against the Pallas kernel in interpret mode."""
    args = _freq_args(hid + out, 3, 32, 8, hid, out)
    jx = [jnp.asarray(a) for a in args]
    tx = [torch.from_numpy(a) for a in args]
    got = K1.freq_lstm_tiled(*tx, groups=2)
    assert got.shape == (3, out)
    assert float((got - K1.freq_lstm_plain(*tx)).abs().max()) < TOL_PLAIN
    assert float(np.abs(got.numpy() - np.asarray(freq_lstm_reference(*jx))).max()) < TOL_JAX
    if hid == 128:
        want = freq_lstm_fused(*jx, block_rows=8, interpret=True, precise=True)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL_JAX
