"""The port's VOCASET preprocessing (``python -m sdfa_tpu_torch preprocess``)
against ``sdfa_tpu.data.vocaset.preload.run_pipeline`` on one raw tree in
VOCASET's layout at FLAME's counts (``mesh.synthetic_template(0)``, its
non-face mask written beside it as data; 1 s of audio and 12 mesh frames a
sentence, as ``tests/test_preprocess.py``'s fixture). The JAX pipeline runs
with its FLAME template path and mask reader pointed at the same files; the
port's through ``main([...])`` on the CPU.

- the clean and preload stages are numpy on both sides: every wav, vad
  pair, frame, lips distance, audio blob (the pitch variants included) and
  CSV bit for bit;
- the dgrad files ≤ 1e-6 (float64 extraction on each side, saved float32;
  rotations within 1% of the 1e-6 rad cut left out, ``rotation_cut_flips``);
- the PCA against sklearn's: the same count, components ≤ 1e-5, means
  ≤ 1e-7; the fit's two routes (thin SVD, the covariance's top eigenpairs
  by subspace iteration) and its numpy plain version agree, also where the
  iteration's block must grow; an iteration that does not converge raises;
- a few frames solved back from their dgrad files reach the template plus
  the smoothed offsets;
- the refusals of the preprocess mode.
"""

import os

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter1d

from sdfa_tpu.data import csvio as jcsvio
from sdfa_tpu.data.vocaset import config as jvc
from sdfa_tpu.data.vocaset import preload as jpreload

from sdfa_tpu_torch.__main__ import main
from sdfa_tpu_torch.audio import io as audio_io
from sdfa_tpu_torch.data.vocaset import config as vc
from sdfa_tpu_torch.data.vocaset import preload
from sdfa_tpu_torch.mesh import read_ply, synthetic_template, write_ply
from sdfa_tpu_torch.ops.deform_solver import DeformationSolver
from sdfa_tpu_torch.ops.dgrad import rotation_cut_flips

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

DGRAD_TOL = 1e-6
PCA_COMP_TOL, PCA_MEAN_TOL = 1e-5, 1e-7
ROUNDTRIP_TOL_M = 1e-4  # float32 dgrad files solved back (tests/test_deformation.py:168)
SENTENCES = [("m3", 38), ("f4", 21)]  # m3's 38th is in both trim tables; f4 validates


def write_raw_tree(root, seconds=1.0, n_frames=12):
    """A raw VOCASET tree and a FLAME-layout template with its mask → the
    template's path. Speech fills the whole clip; the motion is a bump in
    the free band of the template, two bumps that move no constrained
    vertex."""
    verts, faces, cnst = synthetic_template(0)
    tpl = os.path.join(root, "flame", "template", "FLAME_sample.ply")
    os.makedirs(os.path.dirname(tpl))
    write_ply(tpl, verts, faces)
    os.makedirs(os.path.join(root, "flame", "mask"))
    is_cnst = np.zeros(len(verts), bool)
    is_cnst[cnst] = True
    tris = np.nonzero(is_cnst[faces].all(1))[0]
    with open(os.path.join(root, "flame", "mask", "non_face.py"), "w") as fp:
        fp.write(f"non_face_verts = {cnst.tolist()}\nnon_face_tris = {tris.tolist()}\n")
    v32 = read_ply(tpl, dtype=np.float64)[0]
    bumps = [np.exp(-np.sum((v32 - v32[c]) ** 2, 1) / (2 * 0.015 ** 2)) * ~is_cnst
             for c in (7 * 86 + 10, 5 * 86 + 50)]
    sr = 22050
    raw = os.path.join(root, "raw")
    for spk, sent in SENTENCES:
        alias = vc.SPEAKER_ALIAS[spk]
        t = np.arange(int(seconds * sr)) / sr
        wav = 0.3 * np.sin(2 * np.pi * 160 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        os.makedirs(os.path.join(raw, "audio", alias), exist_ok=True)
        audio_io.save(os.path.join(raw, "audio", alias, f"sentence{sent:02d}.wav"),
                      wav.astype(np.float32), sr)
        os.makedirs(os.path.join(raw, "templates"), exist_ok=True)
        write_ply(os.path.join(raw, "templates", f"{alias}.ply"), verts, faces)
        mdir = os.path.join(raw, "unposedcleaneddata", alias, f"sentence{sent:02d}")
        os.makedirs(mdir)
        for fi in range(n_frames):
            phase = 2 * np.pi * fi / n_frames
            move = (0.004 * np.sin(phase) * bumps[0][:, None] * np.array([0.3, -1.0, 0.2])
                    + 0.002 * np.cos(2 * phase) * bumps[1][:, None] * np.array([1.0, 0.2, 0.5]))
            write_ply(os.path.join(mdir, f"sentence{sent:02d}.{fi:06d}.ply"), v32 + move, faces)
    return raw, tpl


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(raw root, template, the JAX pipeline's output, the port's)."""
    root = str(tmp_path_factory.mktemp("voca_pre"))
    raw, tpl = write_raw_tree(root)
    masks = vc.non_face_masks(tpl)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvc, "TEMPLATE_PLY", tpl)
        mp.setattr(jvc, "non_face_masks", lambda: masks)
        jpreload.run_pipeline(raw, os.path.join(root, "jax"), pitch_variants=True)
    got = main(["preprocess", "--source_root", raw, "--dataset_root",
                os.path.join(root, "port"), "--template_mesh", tpl, "--pitch_variants",
                "--platform", "cpu"])
    assert got == os.path.join(root, "port", "dgrad")
    return raw, tpl, os.path.join(root, "jax"), os.path.join(root, "port")


def _files(root, sub):
    base = os.path.join(root, sub)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def _rows(root, sub, name):
    rows = jcsvio.read_csv(os.path.join(root, sub, name))
    for r in rows:
        r["npy_data_path:path"] = os.path.relpath(str(r["npy_data_path:path"]), root)
    return rows


def test_denoise_logmmse_bit_for_bit():
    rng = np.random.default_rng(1)
    sr = 8000
    sig = (0.3 * np.sin(2 * np.pi * 200 * np.arange(2 * sr) / sr)
           + rng.normal(0, 0.02, 2 * sr)).astype(np.float32)
    sig[:sr // 2] = rng.normal(0, 0.02, sr // 2)
    np.testing.assert_array_equal(preload.denoise_logmmse(sig, sr),
                                  jpreload.denoise_logmmse(sig, sr))


def test_clean_stage_bit_for_bit(trees):
    _, _, jroot, troot = trees
    files = _files(jroot, "_clean")
    assert files == _files(troot, "_clean") and "m3/m3_038.vad" in files
    for f in files:
        with open(os.path.join(jroot, "_clean", f), "rb") as a, \
                open(os.path.join(troot, "_clean", f), "rb") as b:
            assert a.read() == b.read(), f


def test_preload_stage_bit_for_bit(trees):
    _, _, jroot, troot = trees
    files = _files(jroot, "offsets/data")
    assert files == _files(troot, "offsets/data")
    assert any(f.split("/")[-1].startswith("-") for f in files)  # negative frame numbers
    for f in files:
        a = np.load(os.path.join(jroot, "offsets/data", f))
        b = np.load(os.path.join(troot, "offsets/data", f))
        if f.endswith(".npz"):
            assert sorted(a.files) == sorted(b.files) and len(a.files) == 14, f
            for k in a.files:  # the 4 sources, sr, start_ts and the 8 pitch variants
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for name in ("train.csv", "valid.csv"):
        assert _rows(jroot, "offsets", name) == _rows(troot, "offsets", name)
    assert not os.path.exists(os.path.join(troot, "offsets", "test.csv"))


def test_dgrad_files(trees):
    _, _, jroot, troot = trees
    files = [f for f in _files(jroot, "dgrad/data")]
    assert files == _files(troot, "dgrad/data")
    worst, moved = 0.0, 0.0
    for f in files:
        a = np.load(os.path.join(jroot, "dgrad/data", f))
        b = np.load(os.path.join(troot, "dgrad/data", f))
        if f.endswith(".npz"):
            continue
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, f
        diff = np.abs(a - b)
        if not f.endswith("_lips_dist.npy"):
            # a rotation within 1% of the extraction's 1e-6 rad cut may land on
            # either side of it in the two libraries' float64 SVDs
            diff = diff.reshape(-1, 9)
            diff[rotation_cut_flips(a.reshape(-1, 9), b.reshape(-1, 9)), 6:] = 0.0
        worst = max(worst, float(diff.max()))
        moved = max(moved, float(np.abs(a).max()))
    assert worst <= DGRAD_TOL and moved > 1e-3, (worst, moved)
    for name in ("train.csv", "valid.csv"):
        assert _rows(jroot, "dgrad", name) == _rows(troot, "dgrad", name)


@pytest.mark.parametrize("part", ["offsets/pca/", "dgrad/pca/scale_", "dgrad/pca/rotat_"])
def test_pca_matches_sklearn(trees, part):
    _, _, jroot, troot = trees
    want = np.load(os.path.join(jroot, part + "compT.npy"))
    got = np.load(os.path.join(troot, part + "compT.npy"))
    assert got.shape == want.shape and got.shape[1] >= 1
    assert float(np.abs(got - want).max()) <= PCA_COMP_TOL
    means = [np.load(os.path.join(r, part + "means.npy")) for r in (jroot, troot)]
    assert float(np.abs(means[0] - means[1]).max()) <= PCA_MEAN_TOL


def test_pca_routes_agree(trees):
    """The thin-SVD and covariance routes of the fit and its numpy plain
    version, on the rotation part of the first 200 moving triangles of the
    training frames (the covariance of all 29928 columns is a minutes-long
    eigh on this CPU)."""
    _, _, _, troot = trees
    data = preload._load_training_frames(os.path.join(troot, "dgrad"), 1).reshape(
        -1, vc.N_TRIS, 9)[:, :, 6:]
    data = data[:, np.abs(data).max((0, 2)) > 0][:, :200].reshape(len(data), -1)
    assert data.shape[1] == 600
    c_np, m_np = preload.fit_pca_np(data)
    for route in ("svd", "gram"):
        c, m = preload.fit_pca(data, device="cpu", route=route)
        assert c.shape == c_np.shape, route
        assert float(np.abs(c - c_np).max()) <= PCA_COMP_TOL, route
        assert float(np.abs(m - m_np).max()) <= 1e-12, route


GRAM_TOL = 1e-8  # the covariance route against numpy's SVD on well-separated spectra


def _spectrum_rows(n, f, latent, decay, seed):
    """Seeded rows with a power-law spectrum (variance j^-2·decay) plus noise."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, latent)) * np.arange(1, latent + 1) ** -decay
    x = z @ rng.standard_normal((latent, f)) / np.sqrt(f)
    return (x + 1e-4 * rng.standard_normal((n, f))).astype(np.float32)


@pytest.mark.parametrize("n,f,latent,decay", [(400, 300, 120, 0.8), (60, 500, 80, 0.5),
                                              (500, 400, 300, 1.2)])
def test_pca_gram_block_growth(monkeypatch, n, f, latent, decay):
    """The covariance route from a block of 8 columns, doubled while the
    count needs more, against the numpy plain version: the same count and
    components."""
    monkeypatch.setattr(preload, "PCA_BLOCK", 8)
    data = _spectrum_rows(n, f, latent, decay, seed=n + f)
    want, want_mean = preload.fit_pca_np(data)
    assert 2 * len(want) > 8  # more than half the first block: it must grow
    got, mean = preload.fit_pca(data, device="cpu", route="gram")
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= GRAM_TOL
    assert float(np.abs(mean - want_mean).max()) <= 1e-12


def test_pca_gram_unconverged_raises(monkeypatch):
    """An iteration that does not reach its residual bound raises rather
    than returning loose components."""
    monkeypatch.setattr(preload, "PCA_MAX_ITERS", 1)
    data = _spectrum_rows(400, 600, 400, 0.3, seed=1)
    with pytest.raises(RuntimeError, match="did not converge"):
        preload.fit_pca(data, device="cpu", route="gram")


def test_dgrad_solves_back_to_offsets(trees):
    """Frames of a training sentence: its dgrad files through the float64
    solve reach the template plus the smoothed offsets."""
    _, tpl, _, troot = trees
    verts, faces = read_ply(tpl, dtype=np.float64)
    nf_verts, _ = vc.non_face_masks(tpl)
    solver = DeformationSolver(verts, faces, nf_verts)
    row = _rows(troot, "offsets", "train.csv")[0]
    src = os.path.join(troot, str(row["npy_data_path:path"]))
    frames = sorted((f for f in os.listdir(src) if preload._NPY_FRAME_RE.match(f)),
                    key=lambda f: int(f[:-4]))
    offsets = gaussian_filter1d(np.stack([np.load(os.path.join(src, f)) for f in frames]),
                                sigma=1.0, axis=0)
    dgrad_dir = src.replace(os.path.join(troot, "offsets"), os.path.join(troot, "dgrad"))
    errs = []
    for i in np.linspace(0, len(frames) - 1, 4).astype(int):
        g = np.load(os.path.join(dgrad_dir, frames[i])).reshape(-1, 9)
        want = verts + offsets[i].reshape(-1, 3).astype(np.float64)
        errs.append(float(np.abs(solver.solve_host(g) - want).max()))
    assert max(errs) <= ROUNDTRIP_TOL_M, errs
    assert float(np.abs(offsets).max()) > 1e-3  # the sentence moves
