"""The biLSTM layer kernels' tiling, walked in plain tensors on the CPU.

``bilstm_layer_tiled`` / ``bilstm2_tiled`` mirror what the CUDA kernels of
``csrc/bilstm_layer.cuh`` do that is not arithmetic: row chunks, the input
projection ahead of the recurrence, row tiles, the gate columns each block
of a cluster owns, k split in interleaved quarters, double-buffered h, and
the 2-layer kernel's two phases per chunk. They are held to the plain
versions and to the JAX package's references at the hidden size the kernel
takes (H = 256, and H = 128 where the cases say so), small T and a narrow
input. Tolerance 1e-5 against the plain versions and the scan references:
float32 on both sides, the sums taken in another order; 5e-5 (the repo's
forward budget) against the JAX Pallas kernels run in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops.pallas_bilstm import bilstm_layer_fused, bilstm_layer_reference
from sdfa_tpu.ops.pallas_bilstm2 import bilstm_2layer_reference
from sdfa_tpu_torch.ops import bilstm2 as K2
from sdfa_tpu_torch.ops import bilstm_layer as K4

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

H = 256
TOL = 1e-5  # f32 sums in another order
TOL_JAX = 5e-5  # forward vs the JAX package's Pallas kernel


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _weights(rng, n_in, bias, hid=H):
    return [_rand(rng, (2, n_in, 4 * hid), 0.1), _rand(rng, (2, hid, 4 * hid), 0.06),
            _rand(rng, (2, 4 * hid), 0.1) if bias else None]


def _layer_args(rng, rows, steps, n_in, bias, hid=H):
    return [_rand(rng, (rows, steps, n_in), 1.0)] + _weights(rng, n_in, bias, hid)


def _both(args):
    return ([None if a is None else jnp.asarray(a) for a in args],
            [None if a is None else torch.from_numpy(a) for a in args])


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_layer_tiled_matches_plain_and_reference(rows, bias):
    """33 rows: two full sub-tiles and one of a single row; T = 3 flips the h
    buffers twice."""
    jx, tx = _both(_layer_args(np.random.default_rng(10 + rows), rows, 3, 12, bias))
    got = K4.bilstm_layer_tiled(*tx)
    assert got.shape == (rows, 3, 2 * H)
    assert float((got - K4.bilstm_layer_plain(*tx)).abs().max()) < TOL
    assert float(np.abs(got.numpy() - np.asarray(bilstm_layer_reference(*jx))).max()) < TOL


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_bilstm2_tiled_matches_plain_and_reference(rows, bias):
    rng = np.random.default_rng(20 + rows)
    args = _layer_args(rng, rows, 2, 9, bias) + _weights(rng, 2 * H, bias)
    jx, tx = _both(args)
    got = K2.bilstm2_tiled(*tx)
    assert got.shape == (rows, 2, 2 * H)
    assert float((got - K2.bilstm2_plain(*tx)).abs().max()) < TOL
    assert float(np.abs(got.numpy() - np.asarray(bilstm_2layer_reference(*jx))).max()) < TOL


def test_tiled_walks_row_chunks(monkeypatch):
    """With the scratch bound cut to 64 (row, step) pairs, 70 rows at T = 2 are
    three chunks (32, 32, 6) for the layer and for both phases of the 2-layer
    kernel."""
    monkeypatch.setattr(K4, "SCRATCH_ROW_STEPS", 64)
    assert K4.chunk_rows(2, H) == 32
    rng = np.random.default_rng(30)
    args = _layer_args(rng, 70, 2, 5, True)
    tx = [torch.from_numpy(a) for a in args]
    assert float((K4.bilstm_layer_tiled(*tx) - K4.bilstm_layer_plain(*tx)).abs().max()) < TOL
    tx2 = tx + [torch.from_numpy(a) for a in _weights(rng, 2 * H, True)]
    assert float((K2.bilstm2_tiled(*tx2) - K2.bilstm2_plain(*tx2)).abs().max()) < TOL


def test_block_columns_are_four_strided_runs_and_partition_the_gates():
    """Hidden unit j owns gate columns j, H + j, 2H + j, 3H + j: a block's
    columns are four runs of H / (blocks of a cluster), one per gate, held
    [unit][gate]."""
    blocks = K4.cluster_blocks(H)
    per = H // blocks
    seen = []
    for block in range(blocks):
        cols = K4.block_columns(block, H).reshape(per, 4)
        for gate in range(4):
            want = gate * H + block * per + torch.arange(per)
            assert torch.equal(cols[:, gate], want)
        seen.append(cols.reshape(-1))
    assert torch.equal(torch.cat(seen).sort().values, torch.arange(4 * H))


@pytest.mark.parametrize("steps", [1, 3, 64, 100, 16384, 20000])
def test_scratch_does_not_grow_with_rows(steps):
    """The wrappers allocate ``scratch_rows(rows, T, H)`` rows of xp (2, ·, T,
    4H) and of the 2-layer stack (·, T, 2H): at most ``row_steps(H)`` (row,
    step) pairs, or one row where T alone is more, whatever the batch; the
    same bytes at either width."""
    for hid in K4.HIDDENS:
        chunk = K4.chunk_rows(steps, hid)
        assert chunk >= 1 and (chunk < K4.ROW_TILE or chunk % K4.ROW_TILE == 0)
        bound = max(K4.row_steps(hid), steps)
        sizes = {rows: K4.scratch_rows(rows, steps, hid)
                 for rows in (1, 7, 216, 256, 257, 27648, 10 ** 6)}
        for rows, n in sizes.items():
            assert 1 <= n <= rows
            assert n * steps <= bound
            xp_bytes, stack_bytes = 2 * n * steps * 4 * hid * 4, n * steps * 2 * hid * 4
            assert xp_bytes + stack_bytes <= bound * (8 * hid + 2 * hid) * 4
        assert sizes[10 ** 6] == chunk  # a many-clip batch asks for one chunk
        assert sizes[27648] == min(27648, chunk)
        if steps == 64:
            assert chunk == 256 * H // hid and sizes[216] == 216
            assert 2 * chunk * steps * 4 * hid * 4 == 128 * 2 ** 20  # xp: 128 MiB
            assert chunk * steps * 2 * hid * 4 == 32 * 2 ** 20  # stack: 32 MiB


# --- H = 128: the width the kernels gained for LSTM2d and FreqLstm "last" ------

H128 = 128


@pytest.mark.parametrize("rows", [1, 7, 33])
def test_layer_tiled_h128_matches_plain_and_fused_kernel(rows):
    """A cluster of four blocks at H = 128 and a 128-wide input, against the
    plain version and the JAX ``bilstm_layer_fused`` in interpret mode."""
    args = _layer_args(np.random.default_rng(40 + rows), rows, 3, 128, True, H128)
    jx, tx = _both(args)
    got = K4.bilstm_layer_tiled(*tx)
    assert got.shape == (rows, 3, 2 * H128)
    assert float((got - K4.bilstm_layer_plain(*tx)).abs().max()) < TOL
    want = bilstm_layer_fused(*jx, block_rows=8, interpret=True)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < TOL_JAX


@pytest.mark.parametrize("rows", [1, 33])
def test_bilstm2_tiled_h128_matches_plain_and_reference(rows):
    rng = np.random.default_rng(50 + rows)
    args = _layer_args(rng, rows, 2, 64, False, H128) + _weights(rng, 2 * H128, False, H128)
    jx, tx = _both(args)
    got = K2.bilstm2_tiled(*tx)
    assert got.shape == (rows, 2, 2 * H128)
    assert float((got - K2.bilstm2_plain(*tx)).abs().max()) < TOL
    assert float(np.abs(got.numpy() - np.asarray(bilstm_2layer_reference(*jx))).max()) < TOL


def test_h128_chunks_and_columns(monkeypatch):
    """At H = 128 a chunk holds twice the (row, step) pairs of H = 256 (the
    same scratch bytes), a cluster is four blocks whose columns partition the
    512 gate columns, and the tiled walk over three chunks (32, 32, 6 rows
    with the bound cut) still equals the plain version."""
    assert K4.row_steps(H128) == 2 * K4.row_steps(H) and K4.cluster_blocks(H128) == 4
    assert K4.chunk_rows(32, H128) == 1024 and K4.chunk_rows(64, H128) == 512
    cols = torch.cat([K4.block_columns(b, H128) for b in range(4)])
    assert torch.equal(cols.sort().values, torch.arange(4 * H128))
    monkeypatch.setattr(K4, "SCRATCH_ROW_STEPS", 32)
    assert K4.chunk_rows(2, H128) == 32
    rng = np.random.default_rng(60)
    tx = [torch.from_numpy(a) for a in _layer_args(rng, 70, 2, 5, True, H128)]
    assert float((K4.bilstm_layer_tiled(*tx) - K4.bilstm_layer_plain(*tx)).abs().max()) < TOL


@pytest.mark.parametrize("hid,n_in,ok", [(128, 64, True), (128, 512, True), (256, 512, True),
                                         (256, 513, True), (192, 64, False), (64, 64, False),
                                         (384, 256, True), (640, 1024, True), (512, 0, False)])
def test_takes_names_the_kernel_widths(hid, n_in, ok):
    """Any H that is a multiple of 128 (the cluster step at 128 and 256, the
    wide step loop from 384 on) over any input width."""
    assert K4.takes(hid, n_in) is ok
