"""Each hand-written kernel on the card against its plain PyTorch version on
the same inputs: the serving kernels (flagship widths for the LSTMs, K4 and K2
at H = 128 too, a small mesh for decode + solve, both its bodies; max |diff| <
1e-4, decode + solve < 1e-5 m), the routes that keep every kernel width off the plain
recurrence, the
training core, forward and backward, at the cluster tiling's edges (forward
< 1e-4; gradients < 1e-4 of max |reference|; the backward repeats bit for
bit), the wide step loop (H = 384 and up, inputs past 512; K1 at H = 256
and any output width) at its edges, and the two projections alone (3xTF32 on
the tensor cores) against their plain walks and float64."""

import numpy as np
import pytest
import torch

from sdfa_tpu_torch.mesh import synthetic_template
from sdfa_tpu_torch.ops import bilstm2 as K2
from sdfa_tpu_torch.ops import bilstm_core as K5
from sdfa_tpu_torch.ops import bilstm_layer as K4
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.ops import freq_lstm as K1
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver

pytestmark = pytest.mark.gpu


def _rand(rng, shape, scale):
    return rng.normal(0, scale, shape).astype(np.float32)


def _k1_args(rng, rows, F, C, H, out, bias=True):
    return [_rand(rng, (rows, F, C), 1.0), _rand(rng, (2, C, 4 * H), 0.1),
            _rand(rng, (2, H, 4 * H), 0.1), _rand(rng, (2, 4 * H), 0.1) if bias else None,
            _rand(rng, (F * 2 * H, out), 0.02), _rand(rng, (out,), 0.1) if bias else None]


def _core_inputs(steps, rows, hid, seed=0):
    rng = np.random.default_rng(seed)
    xp = (0.5 * rng.standard_normal((2, steps, rows, 4 * hid))).astype(np.float32)
    w_hh = (rng.standard_normal((2, hid, 4 * hid)) / np.sqrt(hid)).astype(np.float32)
    dout = rng.standard_normal((steps, rows, 2 * hid)).astype(np.float32)
    return xp, w_hh, dout


def test_cuda_kernels_match_plain(cuda):
    """Each serving kernel on the card against its plain version on the same
    inputs (flagship widths for the LSTMs, a small mesh for decode+solve)."""
    rng = np.random.default_rng(4)
    x1 = [None if a is None else torch.from_numpy(a).to(cuda)
          for a in _k1_args(rng, 45, 32, 64, 128, 256)]
    assert float((K1.freq_lstm(*x1) - K1.freq_lstm_plain(*x1)).abs().max()) < 1e-4
    x2 = [torch.from_numpy(a).to(cuda) for a in (
        _rand(rng, (7, 64, 256), 0.5), _rand(rng, (2, 256, 1024), 0.06),
        _rand(rng, (2, 256, 1024), 0.06), _rand(rng, (2, 1024), 0.06),
        _rand(rng, (2, 512, 1024), 0.06), _rand(rng, (2, 256, 1024), 0.06),
        _rand(rng, (2, 1024), 0.06))]
    assert float((K2.bilstm2(*x2) - K2.bilstm2_plain(*x2)).abs().max()) < 1e-4
    for x4 in (x2[:4], [torch.from_numpy(_rand(rng, (7, 64, 512), 0.5)).to(cuda), *x2[4:6],
                        None]):
        assert float((K4.bilstm_layer(*x4) - K4.bilstm_layer_plain(*x4)).abs().max()) < 1e-4
    # ragged: a second row tile of one row, T = 3, an input width off the product's K tile
    x2r = [torch.from_numpy(_rand(rng, (33, 3, 100), 0.5)).to(cuda),
           torch.from_numpy(_rand(rng, (2, 100, 1024), 0.06)).to(cuda), x2[2], None, *x2[4:6], None]
    assert float((K2.bilstm2(*x2r) - K2.bilstm2_plain(*x2r)).abs().max()) < 1e-4
    assert float((K4.bilstm_layer(*x2r[:4]) - K4.bilstm_layer_plain(*x2r[:4])).abs().max()) < 1e-4
    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    tsolver = DeformationSolver(verts, faces, cnst)
    n = tsolver.n_tris
    dsc = K3.prep_consts(_rand(rng, (6 * n, 85), 0.01), _rand(rng, (6 * n,), 0.01),
                         _rand(rng, (3 * n, 180), 0.01), _rand(rng, (3 * n,), 0.01),
                         tsolver, cuda)
    cs = torch.from_numpy(_rand(rng, (11, 85), 1.0)).to(cuda)
    cr = torch.from_numpy(_rand(rng, (11, 180), 1.0)).to(cuda)
    err = (K3.decode_solve(cs, cr, dsc) - K3.decode_solve_plain(cs, cr, dsc)).abs().max()
    assert float(err) < 1e-5


def _fanout(n):
    """(corr_count, corr_faces): two sources on every even triangle, none on
    every fifth, otherwise one to one (``chip_smoke.py::fanout_table``)."""
    count, faces = [], []
    for i in range(n):
        count.append(0 if i % 5 == 4 else 2 if i % 2 == 0 else 1)
        faces.extend([0] if i % 5 == 4 else [i, (i + 3) % n] if i % 2 == 0 else [i])
    return count, faces


@pytest.mark.parametrize("table,windows", [("fanout", 1), ("fanout", 7), ("fanout", 43),
                                           ("identity", 11)])
def test_cuda_decode_solve_full_matches_plain(cuda, table, windows):
    """K3's full body (the table folded into Pt, ΔT decoded per triangle,
    3xTF32 over K = 3T') on a small correspondence table and on the identity
    table against its plain version, the decode, gather and float32 product
    over the equations (< 1e-5 m), within 5e-7 m of the float64 product and
    1e-6 m of its operands repeated in plain tensors; two launches bit for
    bit, each counted once under the full body."""
    verts, faces, cnst = synthetic_template(0, n_major=8, n_minor=10, n_extra=3, n_free=30)
    n = len(faces)
    count, corr = _fanout(n) if table == "fanout" else (None, None)
    solver = DeformationSolver(verts, faces, cnst, corr_count=count, corr_faces=corr)
    assert solver.spec.identity_eq == (table == "identity")
    rng = np.random.default_rng(windows)
    fsc = K3.prep_full_consts(_rand(rng, (6 * n, 85), 0.01), _rand(rng, (6 * n,), 0.01),
                              _rand(rng, (3 * n, 180), 0.01), _rand(rng, (3 * n,), 0.01),
                              solver, cuda)
    assert fsc.b_t.shape == (2, 128, 3 * fsc.t0.shape[1])
    cs = torch.from_numpy(_rand(rng, (windows, 85), 1.0)).to(cuda)
    cr = torch.from_numpy(_rand(rng, (windows, 180), 1.0)).to(cuda)
    before = K3.LAUNCHES["full"]
    got = K3.decode_solve_full(cs, cr, fsc)
    assert torch.equal(K3.decode_solve_full(cs, cr, fsc), got)
    assert K3.LAUNCHES["full"] == before + 2
    assert got.shape == (windows, 3, solver.n_free) and bool(torch.isfinite(got).all())
    assert float((got - K3.decode_solve_full_plain(cs, cr, fsc)).abs().max()) < 1e-5
    assert float((got - K3.decode_solve_full_rounded(cs, cr, fsc)).abs().max()) < 1e-6
    f64 = fsc._replace(**{k: getattr(fsc, k).double() for k in (
        "basis_s", "means_s", "basis_r", "means_r", "p")})
    exact = K3.decode_solve_full_plain(cs.double(), cr.double(), f64)
    assert float((got.double() - exact).abs().max()) < 5e-7


@pytest.mark.parametrize("rows,steps,n_in,bias", [
    (1, 1, 64, True), (7, 3, 256, False), (33, 32, 64, True), (216, 64, 100, False),
    (1025, 32, 64, True), (513, 64, 256, False)])
def test_cuda_layer_kernels_at_h128_match_plain(cuda, rows, steps, n_in, bias):
    """K4 and K2 at H = 128 (clusters of four blocks) against their plain
    versions at ragged row counts: one row, a partial row tile, one row more
    than a chunk at T = 32 (1024 rows) and T = 64 (512); each launch counted
    once, under its width."""
    rng = np.random.default_rng(rows + steps)
    hid, g = 128, 512

    def weights(k):
        return [_rand(rng, (2, k, g), 0.1), _rand(rng, (2, hid, g), 0.09),
                _rand(rng, (2, g), 0.1) if bias else None]

    args = [torch.from_numpy(a).to(cuda) if a is not None else None
            for a in [_rand(rng, (rows, steps, n_in), 0.5)] + weights(n_in) + weights(2 * hid)]
    k4, k2 = K4.LAUNCHES[hid], K2.LAUNCHES[hid]
    got4, got2 = K4.bilstm_layer(*args[:4]), K2.bilstm2(*args)
    assert (K4.LAUNCHES[hid], K2.LAUNCHES[hid]) == (k4 + 1, k2 + 1)
    assert got4.shape == got2.shape == (rows, steps, 2 * hid)
    assert float((got4 - K4.bilstm_layer_plain(*args[:4])).abs().max()) < 1e-4
    assert float((got2 - K2.bilstm2_plain(*args)).abs().max()) < 1e-4


def test_no_plain_route_at_a_kernel_width(cuda):
    """Every width a kernel takes routes to it: the bidirectional stacks at H =
    128 and 256 (1, 2 and 3 layers, eval and training) and FreqLstm in both
    modes leave ``ops.PLAIN_ROUTES`` at 0; H = 64 takes the plain recurrence
    and counts it, as JAX takes its scan; H = 384 runs the wide step loop."""
    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.nn import recurrent as trec

    gen = torch.Generator().manual_seed(0)
    before = ops.PLAIN_ROUTES
    for hid in (128, 256):
        for layers in (1, 2, 3):
            mod = trec.LSTM(64, hid, layers, bidirectional=True)
            mod.reset_parameters(gen)
            mod = mod.to(cuda)
            x = torch.randn(5, 7, 64, generator=gen).to(cuda)
            for training in (False, True):
                out = mod.train(training)(x)
                if training:
                    out.sum().backward()
    for mode in ("full", "last"):
        freq = trec.FreqLstm(64, 8, 128, 256, mode=mode)
        for sub in freq.modules():
            if hasattr(sub, "reset_parameters"):
                sub.reset_parameters(gen)
        freq.to(cuda).eval()(torch.randn(2, 64, 8, 3, generator=gen).to(cuda))
    lstm2d = trec.LSTM2d(64, 128, 2).to(cuda)
    for sub in lstm2d.modules():
        if isinstance(sub, trec.LSTM):
            sub.reset_parameters(gen)
    lstm2d.eval()(torch.randn(2, 64, 8, 3, generator=gen).to(cuda))
    torch.cuda.synchronize()
    assert ops.PLAIN_ROUTES == before
    trec.LSTM(64, 64, 1, bidirectional=True).to(cuda).eval()(torch.zeros(2, 3, 64, device=cuda))
    assert ops.PLAIN_ROUTES == before + 1
    # H = 384 over 128 features: JAX runs its Pallas kernel, the port its wide step loop
    k4 = K4.LAUNCHES[384]
    out = trec.LSTM(128, 384, 1, bidirectional=True).to(cuda).eval()(
        torch.zeros(2, 3, 128, device=cuda))
    assert out.shape == (2, 3, 768) and K4.LAUNCHES[384] == k4 + 1
    assert ops.PLAIN_ROUTES == before + 1


@pytest.mark.parametrize("steps,rows,hid", [
    (5, 7, 128), (3, 1061, 256), (64, 100, 256),
    # the cluster tiling's edges at both widths: one row; T = 2; T = 1 at one row more than a
    # tile; more rows than one wave of resident clusters; T = 64 at 100 rows
    (3, 1, 128), (2, 7, 128), (1, 33, 128), (3, 2113, 128), (64, 100, 128),
    (3, 1, 256), (2, 7, 256), (1, 17, 256), (3, 257, 256)])
def test_cuda_training_core_matches_plain(cuda, steps, rows, hid):
    xp, w_hh, dout = (torch.from_numpy(a).to(cuda) for a in _core_inputs(steps, rows, hid, seed=9))
    xp.requires_grad_()
    w_hh.requires_grad_()
    fwd, bwd = K5.FWD_LAUNCHES, K5.BWD_LAUNCHES
    out = K5.bilstm_core(xp, w_hh)
    got = torch.autograd.grad(out, (xp, w_hh), dout)
    assert (K5.FWD_LAUNCHES, K5.BWD_LAUNCHES) == (fwd + 1, bwd + 1)
    ref = K5.bilstm_core_plain(xp, w_hh)
    want = torch.autograd.grad(ref, (xp, w_hh), dout)
    assert float((out - ref).abs().max()) < 1e-4
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-4
    # the partial sums are added in a fixed order: the same inputs give the same bits
    assert torch.equal(got[0], torch.autograd.grad(K5.bilstm_core(xp, w_hh), (xp,), dout)[0])


def test_dgrad_extraction_on_card_matches_numpy(cuda):
    """The preprocessing's float64 extraction on the card (cuSOLVER's batched
    SVD) against its numpy plain version (LAPACK), at FLAME's counts over a
    batch of frames: ≤ 1e-10 (a rotation within 1% of the 1e-6 rad cut may
    land on either side of it), degenerate triangles zero on both sides."""
    from sdfa_tpu_torch.ops.dgrad import (deformation_gradients_f64, deformation_gradients_np,
                                          rotation_cut_flips)

    verts, faces, _ = synthetic_template(0)
    rng = np.random.default_rng(5)
    frames = []
    for k in range(8):
        w = np.exp(-np.sum((verts - verts[rng.integers(1200)]) ** 2, 1) / (2 * 0.02 ** 2))
        frames.append(verts + 0.004 * (k + 1) * w[:, None] * rng.normal(size=3))
    frames[3][faces[0, 2]] = frames[3][faces[0, 0]] + 2.0 * (frames[3][faces[0, 1]]
                                                             - frames[3][faces[0, 0]])
    got = deformation_gradients_f64(torch.from_numpy(verts).to(cuda),
                                    torch.from_numpy(np.stack(frames)).to(cuda),
                                    torch.from_numpy(faces).to(cuda)).cpu().numpy()
    want = np.stack([deformation_gradients_np(verts, f, faces) for f in frames])
    diff = np.abs(got - want)
    for k in range(len(frames)):  # rotations within 1% of the 1e-6 rad cut: either side
        diff[k, rotation_cut_flips(want[k], got[k]), 6:] = 0.0
    assert float(diff.max()) <= 1e-10
    assert np.abs(got[3, 0]).max() == 0.0 and np.abs(got).max() > 1e-3


@pytest.mark.parametrize("rows,steps,n_in,hid,bias", [
    (1, 1, 100, 384, True), (33, 3, 1000, 512, False), (40, 5, 768, 384, True),
    (513, 2, 384, 384, False), (7, 4, 1024, 512, True), (5, 2, 64, 640, True),
    (385, 2, 64, 512, False), (9, 3, 64, 1024, True)])
def test_cuda_wide_layer_kernels_match_plain(cuda, rows, steps, n_in, hid, bias):
    """K4 and K2 through the wide step loop: one row, a partial row tile, an
    input off the projection's k tile and past 512, two and three waves' worth
    of rows at H = 384 and 512 (513 and 385; the card's waves are
    ``test_cuda_wide_edges_at_the_wave``'s), H = 640 and 1024; each launch
    counted once, under its width."""
    rng = np.random.default_rng(rows + hid)
    g = 4 * hid

    def weights(k):
        return [_rand(rng, (2, k, g), k ** -0.5), _rand(rng, (2, hid, g), hid ** -0.5),
                _rand(rng, (2, g), 0.1) if bias else None]

    args = [torch.from_numpy(a).to(cuda) if a is not None else None
            for a in [_rand(rng, (rows, steps, n_in), 0.5)] + weights(n_in) + weights(2 * hid)]
    k4, k2 = K4.LAUNCHES[hid], K2.LAUNCHES[hid]
    got4, got2 = K4.bilstm_layer(*args[:4]), K2.bilstm2(*args)
    assert (K4.LAUNCHES[hid], K2.LAUNCHES[hid]) == (k4 + 1, k2 + 1)
    assert float((got4 - K4.bilstm_layer_plain(*args[:4])).abs().max()) < 1e-4
    assert float((got2 - K2.bilstm2_plain(*args)).abs().max()) < 1e-4


@pytest.mark.parametrize("rows,n_freq,hid,out", [
    (45, 32, 256, 512), (37, 4, 384, 384), (5, 3, 256, 201), (33, 2, 512, 200),
    (600, 2, 384, 7)])
def test_cuda_freq_lstm_at_other_widths_matches_plain(cuda, rows, n_freq, hid, out):
    """K1 at H = 256 (the layer kernels' cluster step) and from 384 on (the
    wide loop), at output widths that are no multiple of the 128-column tile
    or of 4 (scalar loads and stores); launched twice, the same bits."""
    rng = np.random.default_rng(rows + out)
    x1 = [None if a is None else torch.from_numpy(a).to(cuda)
          for a in _k1_args(rng, rows, n_freq, 64, hid, out)]
    got = K1.freq_lstm(*x1)
    assert got.shape == (rows, out)
    assert float((got - K1.freq_lstm_plain(*x1)).abs().max()) < 1e-4
    assert torch.equal(got, K1.freq_lstm(*x1))


# --- K1's output projection alone (out_parts_kernel + out_sum_kernel, 3xTF32) -------


def _out_operands(rows, k, out, seed, bias=True):
    """h as the step loop leaves it (|h| < 1), w_proj and b_proj at the kernel
    phase's scales."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (rows, k)).astype(np.float32), _rand(rng, (k, out), 0.02),
            _rand(rng, (out,), 0.1) if bias else None)


@pytest.mark.parametrize("rows,k,out,bias", [
    (768, 8192, 256, True),    # a request's, H = 128
    (12, 8192, 256, True),     # a stream's first block
    (129, 16384, 512, False),  # H = 256, out 512: one row past a 128-row tile
    (37, 24576, 384, True),    # H = 384
    (5, 32768, 512, False),    # H = 512
    (33, 1280, 201, True),     # an output width off the 128-column tile; a half slab
    (3, 8192, 7, False)])      # an output width off 4: 4-byte copies, scalar stores
def test_cuda_output_projection_matches_plain_and_float64(cuda, rows, k, out, bias):
    """The output projection alone against ``output_projection_tiled`` (< 1e-4)
    and against a float64 product (< 1e-5 of the largest |out|), launched twice
    for the same bits."""
    h, w, b = (None if a is None else torch.from_numpy(a).to(cuda)
               for a in _out_operands(rows, k, out, rows + k + out, bias))
    got = K1.output_projection(h, w, b)
    assert got.shape == (rows, out)
    assert float((got - K1.output_projection_tiled(h, w, b)).abs().max()) < 1e-4
    exact = h.double() @ w.double()
    if b is not None:
        exact = exact + b.double()
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())
    assert torch.equal(got, K1.output_projection(h, w, b))


def test_cuda_output_projection_rows_do_not_depend_on_the_call(cuda):
    """A row's output is the same bits whichever rows share its call (a
    session's 12-row block against a server's round): the tiles and the slabs
    do not depend on the row count. The same holds for K1 as a whole."""
    h, w, b = (torch.from_numpy(a).to(cuda) for a in _out_operands(300, 8192, 256, 6))
    whole = K1.output_projection(h, w, b)
    assert torch.equal(K1.output_projection(h[:12].contiguous(), w, b), whole[:12])
    assert torch.equal(K1.output_projection(h[130:200].contiguous(), w, b), whole[130:200])
    rng = np.random.default_rng(13)
    x1 = [torch.from_numpy(a).to(cuda) for a in _k1_args(rng, 140, 32, 64, 128, 256)]
    k1_whole = K1.freq_lstm(*x1)
    assert torch.equal(K1.freq_lstm(x1[0][:12].contiguous(), *x1[1:]), k1_whole[:12])


def test_cuda_output_projection_reads_w_proj_off_16_bytes(cuda):
    """A w_proj that starts 4 bytes past an aligned address is copied 4 bytes at
    a time and gives the aligned w_proj's result bit for bit."""
    h, w, b = (torch.from_numpy(a).to(cuda) for a in _out_operands(50, 2048, 256, 5))
    buf = torch.empty(1 + w.numel(), device=cuda)
    off = buf[1:].view(w.shape)
    off.copy_(w)
    assert off.data_ptr() % 16
    assert torch.equal(K1.output_projection(h, off, b), K1.output_projection(h, w, b))


def test_cuda_output_projection_sees_a_weight_updated_in_place(cuda):
    """w_proj is read as it lies on every launch: after it is changed in place
    (as an optimizer step does between two ``plot_forward`` calls), K1 gives the
    new weights' result, not the old one's."""
    rng = np.random.default_rng(12)
    x1 = [torch.from_numpy(a).to(cuda) for a in _k1_args(rng, 9, 32, 64, 128, 256)]
    before = K1.freq_lstm(*x1)
    with torch.no_grad():
        x1[4].mul_(-0.5)
    after, want = K1.freq_lstm(*x1), K1.freq_lstm_plain(*x1)
    assert float((after - want).abs().max()) < 1e-4
    assert float((before - want).abs().max()) > 1e-2


@pytest.mark.parametrize("steps,rows,hid", [
    (3, 1, 384), (2, 7, 512), (1, 33, 384), (3, 513, 384), (64, 100, 512), (2, 40, 640),
    (2, 385, 512), (2, 9, 1024)])
def test_cuda_wide_training_core_matches_plain(cuda, steps, rows, hid):
    """K5 through the wide step loop: one row, a partial row tile, T = 1, rows
    past one or two waves at H = 384 and 512, H = 640 and 1024; forward < 1e-4,
    the backward's gradients < 1e-4 of the largest; the same bits twice."""
    xp, w_hh, dout = (torch.from_numpy(a).to(cuda)
                      for a in _core_inputs(steps, rows, hid, seed=11))
    xp.requires_grad_()
    w_hh.requires_grad_()
    out = K5.bilstm_core(xp, w_hh)
    got = torch.autograd.grad(out, (xp, w_hh), dout)
    ref = K5.bilstm_core_plain(xp, w_hh)
    want = torch.autograd.grad(ref, (xp, w_hh), dout)
    assert float((out - ref).abs().max()) < 1e-4
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)) < 1e-4
    assert torch.equal(got[0], torch.autograd.grad(K5.bilstm_core(xp, w_hh), (xp,), dout)[0])


@pytest.mark.parametrize("hid", [384, 512])
@pytest.mark.parametrize("edge", ["one_row", "partial_tile", "one_step", "past_a_wave"])
def test_cuda_wide_edges_at_the_wave(cuda, edge, hid):
    """The wide step loop at the edges of its tiling as the card runs it
    (``WIDE_ROW_TILE`` rows a block; the rows one cooperative launch takes read
    from the card's resident blocks, the forward's and the backward's apart):
    one row, a partial row tile, T = 1, and one row past a wave of each pass
    (two launches, the second of one row). K4 and K2 (the forward, a row's
    steps together) and K5's forward and backward (by time) against their
    plain versions: < 1e-4, the backward's gradients < 1e-4 of the largest."""
    tile = K4.WIDE_ROW_TILE
    blocks = K5.wide_resident_blocks(cuda)
    waves = {"fwd": K4.wide_wave_rows(hid, blocks["fwd"]),
             "bwd": K4.wide_wave_rows(hid, blocks["bwd"])}
    assert K4.wide_resident_blocks(cuda) == blocks["fwd"] and min(waves.values()) >= tile
    rows, steps = {"one_row": ([1], 3), "partial_tile": ([tile + 5], 3), "one_step": ([7], 1),
                   "past_a_wave": ([waves["fwd"] + 1, waves["bwd"] + 1], 2)}[edge]
    rng = np.random.default_rng(hid + steps)
    for n in rows:
        x = torch.from_numpy(_rand(rng, (n, steps, 256), 0.5)).to(cuda)
        w = [torch.from_numpy(a).to(cuda) for a in (
            _rand(rng, (2, 256, 4 * hid), 1 / 16), _rand(rng, (2, hid, 4 * hid), hid ** -0.5),
            _rand(rng, (2, 4 * hid), 0.1), _rand(rng, (2, 2 * hid, 4 * hid), 1 / 16),
            _rand(rng, (2, hid, 4 * hid), hid ** -0.5), _rand(rng, (2, 4 * hid), 0.1))]
        assert float((K4.bilstm_layer(x, *w[:3]) - K4.bilstm_layer_plain(x, *w[:3])).abs()
                     .max()) < 1e-4
        assert float((K2.bilstm2(x, *w) - K2.bilstm2_plain(x, *w)).abs().max()) < 1e-4
        xp, w_hh, dout = (torch.from_numpy(a).to(cuda)
                          for a in _core_inputs(steps, n, hid, seed=n))
        xp.requires_grad_()
        w_hh.requires_grad_()
        out = K5.bilstm_core(xp, w_hh)
        got = torch.autograd.grad(out, (xp, w_hh), dout)
        ref = K5.bilstm_core_plain(xp, w_hh)
        want = torch.autograd.grad(ref, (xp, w_hh), dout)
        assert float((out - ref).abs().max()) < 1e-4
        for g, w_ in zip(got, want):
            assert float((g - w_).abs().max() / w_.abs().max().clamp_min(1e-30)) < 1e-4


# --- the input projection alone (proj_kernel in 3xTF32), at each instantiation -------


@pytest.mark.parametrize("hid,rows,steps,n_in,bias", [
    (128, 7, 32, 64, True),      # <512>: K1's input width; 224 pairs, a partial row tile
    (128, 3, 5, 67, False),      # an input width off 4: through the padded copy
    (256, 5, 64, 256, True),     # <1024>: K2's first layer; 320 pairs
    (256, 3, 7, 100, False),     # K = 100: a partial k tile, padded copy
    (384, 2, 9, 768, True),      # <0>: wide384's deeper layers
    (1024, 1, 3, 1024, False)])  # <0> at H = 1024: 8192 gate columns, 3 pairs
def test_cuda_projection_matches_plain_and_float64(cuda, hid, rows, steps, n_in, bias):
    """The projection alone against ``projection_tiled`` (< 1e-4) and against a
    float64 product (< 1e-5 of the largest |xp|), with and without the gate
    bias, at M not a multiple of the 128-row tile."""
    rng = np.random.default_rng(hid + n_in)
    x = torch.from_numpy(_rand(rng, (rows, steps, n_in), 1.0)).to(cuda)
    w_ih = torch.from_numpy(_rand(rng, (2, n_in, 4 * hid), n_in ** -0.5)).to(cuda)
    gb = torch.from_numpy(_rand(rng, (2, 4 * hid), 0.1)).to(cuda) if bias else None
    got = K4.projection(x, w_ih, gb)
    assert float((got - K4.projection_tiled(x, w_ih, gb)).abs().max()) < 1e-4
    exact = torch.stack([x.double() @ w_ih[d].double() for d in range(2)])
    if bias:
        exact = exact + gb.double()[:, None, None]
    assert float((got.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


def test_cuda_projection_reads_x_off_16_bytes(cuda):
    """An x that starts 4 bytes past an aligned address goes through the
    padded copy and gives the aligned x's result bit for bit."""
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(_rand(rng, (1 + 9 * 16 * 64,), 1.0)).to(cuda)
    x = buf[1:].view(9, 16, 64)
    w_ih = torch.from_numpy(_rand(rng, (2, 64, 512), 0.125)).to(cuda)
    assert K4.proj_needs_pad(x)
    assert torch.equal(K4.projection(x, w_ih, None), K4.projection(x.clone(), w_ih, None))


def test_cuda_projection_sees_a_weight_updated_in_place(cuda):
    """The split weights are staged anew on every launch: after w_ih is changed
    in place (as an optimizer step does between two ``plot_forward`` calls),
    each of K4, K2 and K1 gives the new weights' result, not the old one's."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_rand(rng, (5, 6, 256), 0.5)).to(cuda)
    w = [torch.from_numpy(a).to(cuda) for a in (
        _rand(rng, (2, 256, 1024), 0.06), _rand(rng, (2, 256, 1024), 0.06),
        _rand(rng, (2, 1024), 0.06), _rand(rng, (2, 512, 1024), 0.06),
        _rand(rng, (2, 256, 1024), 0.06), _rand(rng, (2, 1024), 0.06))]
    x1 = [None if a is None else torch.from_numpy(a).to(cuda)
          for a in _k1_args(rng, 9, 32, 64, 128, 256)]
    before = (K4.bilstm_layer(x, *w[:3]), K2.bilstm2(x, *w), K1.freq_lstm(*x1))
    with torch.no_grad():
        for weight in (w[0], w[3], x1[1]):  # K4's / K2's first, K2's second layer, K1's w_ih
            weight.mul_(-0.5)
    after = (K4.bilstm_layer(x, *w[:3]), K2.bilstm2(x, *w), K1.freq_lstm(*x1))
    plain = (K4.bilstm_layer_plain(x, *w[:3]), K2.bilstm2_plain(x, *w), K1.freq_lstm_plain(*x1))
    for old, new, want in zip(before, after, plain):
        assert float((new - want).abs().max()) < 1e-4
        assert float((old - want).abs().max()) > 1e-2
