"""The training core's cluster tiling, walked in plain tensors on the CPU.

``forward_steps_tiled`` / ``backward_steps_tiled`` mirror what the CUDA
kernels of ``csrc/bilstm_core.cu`` do that is not arithmetic: sub-tiles of
rows, the gate columns each block of a cluster owns (H / 32 blocks: 4 at
H = 128, 8 at H = 256), the interleaved parts a product is summed in, the
residuals at their TIME index, and, for the backward, every block's partial
sums for all H units added in block order. They are held to the plain
step transcriptions at 1e-6 and to the JAX package — the Pallas forward in
interpret mode, ``jax.grad`` of ``bilstm_core_reference`` for d(xp) and
d(w_hh) — at 1e-5 (relative to the largest gradient for the gradients:
float32 on both sides, the sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.ops import pallas_bilstm_train as J
from sdfa_tpu_torch.ops import bilstm_core as K5
from sdfa_tpu_torch.ops.bilstm_layer import UNITS_PER_BLOCK, block_columns

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

SIZES = [(1, 5), (7, 2), (33, 1), (33, 2), (7, 5)]  # (rows, T): 33 rows = two sub-tiles and a row


def _inputs(steps, rows, hid, seed=0):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((2, steps, rows, 4 * hid))).astype(np.float32)
    w_hh = (rng.standard_normal((2, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    dout = rng.standard_normal((steps, rows, 2 * hid)).astype(np.float32)
    return xp, w_hh, dout


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


@pytest.mark.parametrize("hid", K5.HIDDENS)
@pytest.mark.parametrize("rows,steps", SIZES)
def test_forward_tiled_matches_steps_and_pallas(rows, steps, hid):
    xp, w_hh, _ = _inputs(steps, rows, hid, seed=rows + steps)
    txp, tw = torch.from_numpy(xp), torch.from_numpy(w_hh)
    got = K5.forward_steps_tiled(txp, tw)
    for g, w in zip(got, K5.forward_steps(txp, tw)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-6
    want = np.asarray(J.bilstm_core(jnp.asarray(xp), jnp.asarray(w_hh), interpret=True))
    assert float(np.abs(got[0].numpy() - want).max()) <= 1e-5


@pytest.mark.parametrize("hid", K5.HIDDENS)
@pytest.mark.parametrize("rows,steps", SIZES)
def test_backward_tiled_matches_steps_and_jax_grad(rows, steps, hid):
    xp, w_hh, dout = _inputs(steps, rows, hid, seed=10 + rows + steps)
    txp, tw, tdout = (torch.from_numpy(a) for a in (xp, w_hh, dout))
    out, gates, cs = K5.forward_steps_tiled(txp, tw)
    dg = K5.backward_steps_tiled(gates, cs, tw, tdout)
    want = K5.backward_steps(gates, cs, tw, tdout)
    assert float((dg - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))

    def loss(a, b):
        return jnp.sum(jnp.asarray(dout) * J.bilstm_core_reference(a, b))

    jx, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(w_hh))
    assert _rel(dg.numpy(), np.asarray(jx)) <= 1e-5
    if steps > 1:  # a single step has no recurrent product: d(w_hh) is zero
        assert _rel(K5.dw_hh(out, dg).numpy(), np.asarray(jw)) <= 1e-5
    else:
        assert float(K5.dw_hh(out, dg).abs().max()) == 0.0 == float(np.abs(jw).max())


@pytest.mark.parametrize("hid", K5.HIDDENS)
def test_reverse_direction_with_distinct_steps(hid):
    """A different scale per time step: a slip between time order and the
    reverse direction's step order cannot cancel out, in the residuals'
    indices or in c of the previous step (t + 1 for direction 1)."""
    xp, w_hh, dout = _inputs(3, 2, hid, seed=7)
    xp *= np.asarray([0.2, 1.0, 3.0], np.float32)[None, :, None, None]
    dout *= np.asarray([2.0, 0.5, 1.0], np.float32)[:, None, None]
    txp, tw, tdout = (torch.from_numpy(a) for a in (xp, w_hh, dout))
    out, gates, cs = K5.forward_steps_tiled(txp, tw)
    # direction 1 at t = T − 1 is its first step: gates from xp[1, T − 1] alone
    first = txp[1, 2]
    assert float((gates[1, 2, :, :hid] - torch.sigmoid(first[:, :hid])).abs().max()) <= 1e-6
    assert float((cs[1, 2] - torch.sigmoid(first[:, :hid])
                  * torch.tanh(first[:, 2 * hid:3 * hid])).abs().max()) <= 1e-6
    dg = K5.backward_steps_tiled(gates, cs, tw, tdout)

    def loss(a, b):
        return jnp.sum(jnp.asarray(dout) * J.bilstm_core_reference(a, b))

    jx = jax.grad(loss)(jnp.asarray(xp), jnp.asarray(w_hh))
    assert _rel(dg.numpy(), np.asarray(jx)) <= 1e-5


@pytest.mark.parametrize("hid", K5.HIDDENS)
def test_block_columns_partition_the_gates(hid):
    """Hidden unit j owns gate columns j, H + j, 2H + j, 3H + j; the H / 32
    blocks' slices, each [unit][gate], cover the 4H columns once."""
    blocks = K5.cluster_blocks(hid)
    assert blocks * UNITS_PER_BLOCK == hid
    seen = []
    for block in range(blocks):
        cols = block_columns(block, hid).reshape(UNITS_PER_BLOCK, 4)
        for gate in range(4):
            want = gate * hid + block * UNITS_PER_BLOCK + torch.arange(UNITS_PER_BLOCK)
            assert torch.equal(cols[:, gate], want)
        seen.append(cols.reshape(-1))
    assert torch.equal(torch.cat(seen).sort().values, torch.arange(4 * hid))
    # the backward product's lanes: H / 16 outputs side by side, the columns in 2 or 4 parts
    assert K5.column_parts(hid) * (hid // 16) == 32
    assert UNITS_PER_BLOCK % K5.column_parts(hid) == 0 and K5.ROW_TILE[hid] % 16 == 0


def test_partial_sums_are_added_in_block_order():
    """Float addition does not associate: on a crafted input the block order
    gives one bit pattern, a permuted order another, and the fixed order
    repeats."""
    parts = [torch.tensor([v], dtype=torch.float32) for v in (1e8, 1.0, -1e8, 1.0)]
    assert float(K5.sum_partials(parts)) == 1.0  # ((1e8 + 1) − 1e8) + 1: the first 1 is lost
    assert float(K5.sum_partials(parts, order=[0, 2, 1, 3])) == 2.0
    assert torch.equal(K5.sum_partials(parts), K5.sum_partials(parts))


@pytest.mark.parametrize("hid", K5.HIDDENS)
def test_backward_tiled_order_is_fixed(hid):
    """Through the whole backward walk: the same inputs give the same bits,
    and adding the blocks' partial sums in reverse order does not."""
    xp, w_hh, dout = _inputs(4, 5, hid, seed=21)
    txp, tw, tdout = (torch.from_numpy(a) for a in (xp, w_hh, dout))
    _, gates, cs = K5.forward_steps(txp, tw)
    dg = K5.backward_steps_tiled(gates, cs, tw, tdout)
    assert torch.equal(dg, K5.backward_steps_tiled(gates, cs, tw, tdout))
    flipped = K5.backward_steps_tiled(gates, cs, tw, tdout,
                                      block_order=list(range(K5.cluster_blocks(hid)))[::-1])
    assert not torch.equal(dg, flipped)
    assert float((dg - flipped).abs().max()) <= 1e-5 * float(dg.abs().max())
