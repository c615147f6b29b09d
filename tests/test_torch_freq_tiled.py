"""FreqLstm's kernel tiling, walked in plain tensors on the CPU.

``freq_lstm_tiled`` mirrors what the CUDA kernels of ``csrc/freq_lstm.cu`` do
that is not arithmetic: row chunks of whole waves of resident clusters, the
input projection ahead of the recurrence, the gate columns each of a
cluster's four blocks owns, the two directions apart, the h scratch, and the
output projection in 3xTF32 summed slab by slab in a fixed order (its
accuracy alone: tests/test_torch_outproj_tf32.py). It is held to the
plain version (1e-5: float32 on both sides, the sums taken in another order)
and to the JAX package's reference and its Pallas kernel in interpret mode
(5e-5, the repo's forward budget) at the shipped encoder's hidden size and
output width (H = 128, out = 256), few frequency steps and a narrow input
(the wider ones: tests/test_torch_wide_lstm.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops.pallas_freq_lstm import freq_lstm_fused, freq_lstm_reference
from sdfa_tpu_torch.ops import freq_lstm as K1
from sdfa_tpu_torch.ops.tf32 import tiled_product

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

H, OUT = 128, 256  # the shipped encoder's FreqLstm
TOL_PLAIN = 1e-5  # f32 sums in another order
TOL_JAX = 5e-5    # forward vs the JAX package


def _args(seed, rows, n_freq, n_in, bias):
    rng = np.random.default_rng(seed)

    def rand(shape, scale):
        return rng.normal(0, scale, shape).astype(np.float32)

    return [rand((rows, n_freq, n_in), 1.0), rand((2, n_in, 4 * H), 0.1),
            rand((2, H, 4 * H), 0.1), rand((2, 4 * H), 0.1) if bias else None,
            rand((n_freq * 2 * H, OUT), 0.02), rand((OUT,), 0.1) if bias else None]


def _both(args):
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rows,n_freq,n_in", [(1, 3, 12), (7, 1, 5), (33, 3, 12), (70, 5, 9)])
def test_tiled_matches_plain_and_reference(rows, n_freq, n_in, bias):
    """33 rows: two full sub-tiles and one of a single row; F = 3 flips the h
    buffers twice and leaves a second, half-filled K slab; F = 1 has one slab
    of half a slab's depth; F = 5 three slabs. Two resident clusters: a wave
    is one row tile, so 70 rows are three row tiles in one chunk."""
    jx, tx = _both(_args(100 + rows, rows, n_freq, n_in, bias))
    got = K1.freq_lstm_tiled(*tx, groups=2)
    assert got.shape == (rows, OUT)
    assert float((got - K1.freq_lstm_plain(*tx)).abs().max()) < TOL_PLAIN
    assert float(np.abs(got.numpy() - np.asarray(freq_lstm_reference(*jx))).max()) < TOL_JAX


@pytest.mark.parametrize("rows", [5, 40])
def test_tiled_matches_pallas_interpret(rows):
    jx, tx = _both(_args(200 + rows, rows, 4, 16, True))
    want = np.asarray(freq_lstm_fused(*jx, block_rows=8, interpret=True, precise=True))
    got = K1.freq_lstm_tiled(*tx, groups=2).numpy()
    assert float(np.abs(got - want).max()) < TOL_JAX


def test_tiled_walks_row_chunks(monkeypatch):
    """With the scratch bound cut to 128 (row, step) pairs and two resident
    clusters, 70 rows at F = 2 are three chunks (32, 32, 6), each through all
    three phases."""
    monkeypatch.setattr(K1, "SCRATCH_ROW_STEPS", 128)
    assert K1.chunk_rows(2, 2, H) == 64 and K1.chunk_rows(2, 3, H) == 64
    assert K1.chunk_rows(4, 2, H) == 32
    monkeypatch.setattr(K1, "SCRATCH_ROW_STEPS", 64)
    assert K1.chunk_rows(2, 2, H) == 32
    tx = [None if a is None else torch.from_numpy(a) for a in _args(3, 70, 2, 6, True)]
    assert float((K1.freq_lstm_tiled(*tx, groups=2) - K1.freq_lstm_plain(*tx)).abs().max()) \
        < TOL_PLAIN


def test_slab_sum_order_is_fixed():
    """The slabs are added first to last, then the bias: the default order gives
    the bits of that chain of additions, whatever order the parts were made in,
    and another order gives (slightly) other bits: the order matters and is one."""
    rng = np.random.default_rng(4)
    parts = [torch.from_numpy(rng.normal(0, 1, (9, OUT)).astype(np.float32)) for _ in range(5)]
    bias = torch.from_numpy(rng.normal(0, 1, (OUT,)).astype(np.float32))
    want = ((((parts[0] + parts[1]) + parts[2]) + parts[3]) + parts[4]) + bias
    assert torch.equal(K1.sum_slabs(parts, bias), want)
    assert torch.equal(K1.sum_slabs(parts, bias), K1.sum_slabs(list(parts), bias))
    other = K1.sum_slabs(parts, bias, order=[4, 3, 2, 1, 0])
    assert not torch.equal(other, want)
    assert float((other - want).abs().max()) < 1e-5
    # the tiled walk's output is the slab chain's, bit for bit: each slab a
    # 3xTF32 product k tile by k tile (tiled_product), the slabs added first to last
    tx = [None if a is None else torch.from_numpy(a) for a in _args(5, 6, 5, 7, True)]
    h = K1.layer_tiled_chunk(*tx[:4]).reshape(6, -1)
    chain = tiled_product(h[:, :512], tx[4][:512], K1.OUT_K)
    for k in (512, 1024):
        chain = chain + tiled_product(h[:, k:k + 512], tx[4][k:k + 512], K1.OUT_K)
    assert torch.equal(K1.freq_lstm_tiled(*tx, groups=2), chain + tx[5])


@pytest.mark.parametrize("n_freq,slabs", [(1, 1), (2, 1), (3, 2), (4, 2), (32, 16), (33, 17)])
def test_out_slabs(n_freq, slabs):
    """A slab is K_SLAB = 512 of K = F · 2H: two frequency steps; an odd F ends
    in a slab of one step."""
    assert K1.out_slabs(n_freq * 2 * H) == slabs
    assert K1.K_SLAB % (2 * H) == 0


@pytest.mark.parametrize("clusters", [2, 15, 62, 63, 132])
@pytest.mark.parametrize("steps", [1, 3, 32, 33, 1024, 32768, 40000])
def test_scratch_does_not_grow_past_one_chunk(steps, clusters):
    """The wrapper allocates ``scratch_rows(rows, F, clusters)`` rows of xp
    (2, ·, F, 4H), h (·, F, 2H) and partial sums (slabs, ·, out): at most
    SCRATCH_ROW_STEPS (row, step) pairs, or one row where F alone is more,
    whatever the batch; a chunk is whole waves of resident clusters where a
    wave fits, else whole row tiles."""
    chunk = K1.chunk_rows(steps, clusters, H)
    wave = clusters // 2 * K1.ROW_TILE
    bound = max(K1.SCRATCH_ROW_STEPS, steps)
    assert chunk >= 1 and chunk * steps <= bound
    if chunk >= wave:
        assert chunk % wave == 0
    elif chunk >= K1.ROW_TILE:
        assert chunk % K1.ROW_TILE == 0 and wave * steps > K1.SCRATCH_ROW_STEPS
    sizes = {rows: K1.scratch_rows(rows, steps, clusters, H)
             for rows in (1, 7, 768, 3072, 27648, 10 ** 6)}
    for rows, n in sizes.items():
        assert 1 <= n <= rows and n * steps <= bound
        per_pair = (2 * 4 * H + 2 * H) * 4 + K1.out_slabs(steps * 2 * H) * OUT * 4 / steps
        assert n * steps * per_pair <= bound * (10 * H * 4 + OUT * 4)
    assert sizes[10 ** 6] == chunk  # a many-clip batch asks for one chunk
    if (steps, clusters) == (32, 62):  # the shipped encoder on the card measured so far
        assert chunk == 992 and sizes[768] == 768 and sizes[3072] == 992
