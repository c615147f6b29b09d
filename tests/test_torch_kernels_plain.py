"""The serving kernels' plain PyTorch versions against the JAX package's
references, at small shapes (the training core has
tests/test_torch_train_core.py; the CUDA kernels themselves against these
plain versions run on a card from tests_gpu/test_cuda_kernels.py).

- K1 ``freq_lstm_plain`` vs ``freq_lstm_reference`` (f32 HIGHEST scan) and
  vs the Pallas kernel in interpret mode (3-pass products ≈ f32).
- K2 ``bilstm2_plain`` vs ``bilstm_2layer_reference``. The Pallas kernel's
  interpret output is bf16-rounded by design, so the f32 oracle is the bar.
- K4 ``bilstm_layer_plain`` vs ``bilstm_layer_reference``.
- K3 ``decode_solve_plain`` vs ``decode_solve_fused(interpret=True)`` in
  its f32 configuration (delta off, 3-pass products, f32 P): the default
  delta mode rounds ΔT and P to bf16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.ops import deform_solver as jds
from sdfa_tpu.ops import pallas_decode_solve as jpds
from sdfa_tpu.ops.pallas_bilstm import bilstm_layer_reference
from sdfa_tpu.ops.pallas_bilstm2 import bilstm_2layer_reference
from sdfa_tpu.ops.pallas_freq_lstm import freq_lstm_fused, freq_lstm_reference
from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import bilstm2 as K2
from sdfa_tpu_torch.ops import bilstm_layer as K4
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops import freq_lstm as K1
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _k1_args(rng, rows, F, C, H, out, bias=True):
    return [_rand(rng, (rows, F, C), 1.0), _rand(rng, (2, C, 4 * H), 0.1),
            _rand(rng, (2, H, 4 * H), 0.1), _rand(rng, (2, 4 * H), 0.1) if bias else None,
            _rand(rng, (F * 2 * H, out), 0.02), _rand(rng, (out,), 0.1) if bias else None]


def _both(args):
    jx = [None if a is None else jnp.asarray(a) for a in args]
    tx = [None if a is None else torch.from_numpy(a) for a in args]
    return jx, tx


@pytest.mark.parametrize("bias", [True, False])
def test_freq_lstm_plain_matches_reference(bias):
    jx, tx = _both(_k1_args(np.random.default_rng(0), 37, 6, 8, 16, 12, bias))
    want = np.asarray(freq_lstm_reference(*jx))
    got = K1.freq_lstm(*tx).numpy()  # CPU tensors → the plain version
    assert got.shape == (37, 12)
    assert float(np.abs(got - want).max()) < 1e-5  # f32 both sides


def test_freq_lstm_plain_matches_pallas_interpret():
    """Flagship widths (C 64, H 128, out 256), ragged 130 rows on 128-row
    blocks, 4 frequency steps."""
    jx, tx = _both(_k1_args(np.random.default_rng(1), 130, 4, 64, 128, 256))
    want = np.asarray(freq_lstm_fused(*jx, block_rows=128, interpret=True, precise=True))
    got = K1.freq_lstm_plain(*tx).numpy()
    assert float(np.abs(got - want).max()) < 2e-5  # the 3-pass split ≈ f32


@pytest.mark.parametrize("bias", [True, False])
def test_bilstm2_plain_matches_reference(bias):
    rng = np.random.default_rng(2)
    rows, T, IN, H = 5, 9, 12, 8
    args = [_rand(rng, (rows, T, IN), 1.0),
            _rand(rng, (2, IN, 4 * H), 0.2), _rand(rng, (2, H, 4 * H), 0.2),
            _rand(rng, (2, 4 * H), 0.1) if bias else None,
            _rand(rng, (2, 2 * H, 4 * H), 0.2), _rand(rng, (2, H, 4 * H), 0.2),
            _rand(rng, (2, 4 * H), 0.1) if bias else None]
    jx, tx = _both(args)
    want = np.asarray(bilstm_2layer_reference(*jx))
    got = K2.bilstm2(*tx).numpy()
    assert got.shape == (rows, T, 2 * H)
    assert float(np.abs(got - want).max()) < 1e-5  # f32 both sides


K2_GATE = 1e-4  # K2's kernel against its plain version (chip_smoke.py TOL["bilstm2"])


def test_bilstm2_bf16_output_misses_the_kernel_gate():
    """Why K2's and K4's output stays float32 (the JAX package's TPU default
    stores it in bf16, ``SDFA_LSTM_STAGE_BF16``): h lies in (−1, 1), and a
    bf16 store errs by up to 2^-9 there, past K2's 1e-4 gate against its
    plain version at these narrow shapes. What it would save is half of K2's
    output traffic: 28 MB at a request's 216 windows, written and read once,
    about 17 µs at 3.35 TB/s in float32."""
    rng = np.random.default_rng(2)
    rows, T, IN, H = 5, 9, 12, 8
    tx = [torch.from_numpy(a) for a in (
        _rand(rng, (rows, T, IN), 1.0), _rand(rng, (2, IN, 4 * H), 0.2),
        _rand(rng, (2, H, 4 * H), 0.2), _rand(rng, (2, 4 * H), 0.1),
        _rand(rng, (2, 2 * H, 4 * H), 0.2), _rand(rng, (2, H, 4 * H), 0.2),
        _rand(rng, (2, 4 * H), 0.1))]
    plain = K2.bilstm2_plain(*tx)
    assert float(plain.abs().max()) < 1.0
    bf16 = plain.to(torch.bfloat16).float()
    assert float((bf16 - plain).abs().max()) > K2_GATE
    assert float((bf16 - plain).abs().max()) <= 2.0 ** -9


@pytest.mark.parametrize("bias", [True, False])
def test_bilstm_layer_plain_matches_reference(bias):
    rng = np.random.default_rng(5)
    rows, T, IN, H = 6, 11, 10, 8
    jx, tx = _both([_rand(rng, (rows, T, IN), 1.0), _rand(rng, (2, IN, 4 * H), 0.2),
                    _rand(rng, (2, H, 4 * H), 0.2),
                    _rand(rng, (2, 4 * H), 0.1) if bias else None])
    want = np.asarray(bilstm_layer_reference(*jx))
    got = K4.bilstm_layer(*tx).numpy()  # CPU tensors → the plain version
    assert got.shape == (rows, T, 2 * H)
    assert float(np.abs(got - want).max()) < 1e-5  # f32 both sides


@pytest.fixture(scope="module")
def small_solvers():
    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    return (verts, faces, cnst, jds.DeformationSolver(verts, faces, cnst_indices=cnst),
            DeformationSolver(verts, faces, cnst))


@pytest.mark.parametrize("rows", [9, 16])
def test_decode_solve_plain_matches_pallas_interpret(small_solvers, rows):
    *_, jsolver, tsolver = small_solvers
    n = tsolver.n_tris
    Ks, Kr = 12, 7
    rng = np.random.default_rng(3)
    sc, sm = _rand(rng, (6 * n, Ks), 0.05), _rand(rng, (6 * n,), 0.05)
    rc, rm = _rand(rng, (3 * n, Kr), 0.05), _rand(rng, (3 * n,), 0.05)
    coef_s, coef_r = _rand(rng, (rows, Ks), 1.0), _rand(rng, (rows, Kr), 1.0)
    jdsc = jpds.prep_consts({"compT": sc, "means": sm}, {"compT": rc, "means": rm},
                            jsolver.consts, jsolver.spec, p_dtype=jnp.float32)
    want = np.asarray(jpds.decode_solve_free(jnp.asarray(coef_s), jnp.asarray(coef_r), jdsc,
                                             interpret=True, delta=False, precise=True))
    dsc = K3.prep_consts(sc, sm, rc, rm, tsolver, "cpu")
    got = K3.decode_solve(torch.from_numpy(coef_s), torch.from_numpy(coef_r), dsc).numpy()
    assert got.shape == want.shape == (rows, 3, tsolver.n_free)
    assert float(np.abs(got - want).max()) < 1e-5  # metres; f32 vs the 3-pass split
