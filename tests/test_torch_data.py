"""The port's readers against the JAX package's: CSV manifests, the synthetic
dataset, the sliding-window reader in host-feature and raw mode, PCA and
compact targets, pitch-shift sources, the inference windows of
``fetch_audio_features`` and the host frontend of ``AnimationTask``.

From one root and seed the two readers draw the same random numbers in the
same order, so their batches must be equal bit for bit: arrays, dtypes and
keys. The datasets here are cut to 60 triangles (the readers do not depend on
the mesh) and 1 s sentences; ``tests/test_torch_api_train.py`` generates one
at FLAME's counts.
"""

import glob
import itertools
import os
import shutil

import numpy as np
import pytest

import sdfa_tpu.data.synthetic as jsynth
from sdfa_tpu.data import DatasetSlidingWindow as JReader
from sdfa_tpu.data import csvio as jcsv
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.data import DatasetSlidingWindow as TReader
from sdfa_tpu_torch.data import csvio as tcsv
from sdfa_tpu_torch.data import synthetic as tsynth

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

N_TRIS = 60
GEN = dict(speakers=["m0", "f0"], sentences_per_speaker=1, seconds_per_sentence=1.0,
           pca_dims=(8, 8))


def _generate(module, root, **kw):
    saved = module.N_TRIS
    module.N_TRIS = N_TRIS
    try:
        return module.generate(root, **{"face_type": "dgrad_3d", **GEN, **kw})
    finally:
        module.N_TRIS = saved


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root): the same dataset written by each package."""
    base = tmp_path_factory.mktemp("data")
    return (_generate(jsynth, str(base / "jax")), _generate(tsynth, str(base / "port")))


def _readers(roots, training, overrides=None):
    jroot, troot = roots
    return (JReader(jconfigure("dgrad", overrides=overrides, dataset_root=jroot), training),
            TReader(tconfigure("dgrad", overrides=overrides, dataset_root=troot), training))


def _assert_same_batches(want, got):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
            assert np.array_equal(a[key], b[key]), key


def _load_any(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".npy"):
        return {"": np.load(path)}
    return {"": open(path).read()}


def test_csv_roundtrip_with_path_rerooting(tmp_path):
    rows = [{"npy_data_path:path": str(tmp_path / "data" / "x"), "speaker:str": "m0",
             "n:int": 3, "ts:float": 1.5}]
    tcsv.write_csv(str(tmp_path / "t.csv"), rows)
    jcsv.write_csv(str(tmp_path / "j.csv"), rows)
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()
    back = tcsv.read_csv(str(tmp_path / "j.csv"))
    assert back == jcsv.read_csv(str(tmp_path / "t.csv")) == rows


@pytest.mark.parametrize("face_type,dims", [("dgrad_3d", (8, 8)), ("verts_off_3d", (5,))])
def test_generate_writes_the_same_arrays(tmp_path, face_type, dims):
    """One seed, the same files with equal contents, bit for bit (array
    contents: an .npz archive carries zip timestamps)."""
    jroot = _generate(jsynth, str(tmp_path / "j"), face_type=face_type, pca_dims=dims,
                      sentences_per_speaker=2, seconds_per_sentence=0.5, seed=3)
    troot = _generate(tsynth, str(tmp_path / "t"), face_type=face_type, pca_dims=dims,
                      sentences_per_speaker=2, seconds_per_sentence=0.5, seed=3)
    files = sorted(os.path.relpath(p, jroot) for p in glob.glob(jroot + "/**", recursive=True)
                   if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, troot)
                           for p in glob.glob(troot + "/**", recursive=True)
                           if os.path.isfile(p))
    assert len(files) > 100
    for rel in files:
        want, got = _load_any(os.path.join(jroot, rel)), _load_any(os.path.join(troot, rel))
        assert sorted(want) == sorted(got), rel
        for key in want:
            if isinstance(want[key], str):
                assert want[key] == got[key], rel
            else:
                assert want[key].dtype == got[key].dtype and np.array_equal(want[key], got[key]), \
                    (rel, key)


def test_manifests_and_window_geometry(roots):
    jds, tds = _readers(roots, training=False)
    assert [{k: v for k, v in r.items() if k != "npy_data_path:path"} for r in tds.info_list] \
        == [{k: v for k, v in r.items() if k != "npy_data_path:path"} for r in jds.info_list]
    assert tds.coordinates == jds.coordinates
    # sliding = 64·63 + 512 = 4544 samples = 0.568 s (SURVEY.md §2.5)
    assert tds._sliding_size == 4544
    s, e = tds.coordinates[0]["range"]
    assert e - s == 4544
    assert (len(tds), tds.num_speakers) == (len(jds), jds.num_speakers)
    assert tds.frame_to_sample(3.0) == jds.frame_to_sample(3.0) == 400.0


def test_item_shapes_pairing_and_collate(roots):
    _, ds = _readers(roots, training=False)
    item = ds[0]
    assert item["audio_feat_0"].shape == (64, 128, 3)
    assert item["dgrad_3d_scale_0"].shape == (1, N_TRIS, 6)
    assert item["frame_id_1"] == item["frame_id_0"] + 1
    last = ds[len(ds) - 1]  # a sentence's last window pairs with the one before it
    assert last["frame_id_1"] == last["frame_id_0"] + 1 == len(ds) - 1
    batch = ds.collate([ds[0], ds[1], ds[2]])
    assert batch["audio_feat"].shape == (6, 64, 128, 3)
    assert batch["speaker_id"].shape == (6,) and batch["speaker_id"].dtype == np.int32
    # first half = frame i, second half = frame i + 1 of the same items
    np.testing.assert_array_equal(batch["audio_feat"][0], ds[0]["audio_feat_0"])
    np.testing.assert_array_equal(batch["audio_feat"][3], ds[0]["audio_feat_1"])


def test_training_augments_and_eval_is_deterministic(roots):
    _, train = _readers(roots, training=True)
    assert not np.allclose(train[0]["audio_feat_0"], train[0]["audio_feat_0"])
    _, ev = _readers(roots, training=False)
    np.testing.assert_array_equal(ev[0]["audio_feat_0"], ev[0]["audio_feat_0"])


TARGETS = {"full": None, "pca": {"trainer": {"pca_targets": True}},
           "compact": {"trainer": {"compact_targets": True}},
           "pca-compact": {"trainer": {"pca_targets": True, "compact_targets": True}}}


@pytest.mark.parametrize("targets", sorted(TARGETS))
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("mode", ["batches", "raw_batches"])
def test_batches_are_equal_bit_for_bit(roots, mode, training, targets):
    jds, tds = _readers(roots, training, TARGETS[targets])
    n = 4 if mode == "batches" else 8
    want = list(itertools.islice(getattr(jds, mode)(3), n))
    got = list(itertools.islice(getattr(tds, mode)(3), n))
    _assert_same_batches(want, got)
    keys = set(got[0])
    if targets.startswith("pca"):
        assert {"dgrad_3d_scale_coef", "dgrad_3d_rotat_coef"} <= keys
        assert got[0]["dgrad_3d_scale_coef"].dtype == np.float32  # coefficients stay f32
    else:
        want_dtype = np.float16 if targets == "compact" else np.float32
        assert got[0]["dgrad_3d_scale"].dtype == want_dtype
    if mode == "raw_batches":
        assert got[0]["raw_wav"].shape == (6, 5056) and got[0]["raw_wav"].dtype == np.float32
    # the per-sentence caches the two readers wrote agree too
    for jinfo, tinfo in zip(jds.info_list, tds.info_list):
        for suffix in ("_frames.npy", "_lips.npy") + (("_coeffs.npy",) if "pca" in targets
                                                     else ()):
            np.testing.assert_array_equal(np.load(tinfo["npy_data_path:path"] + suffix),
                                          np.load(jinfo["npy_data_path:path"] + suffix))


def test_coef_targets_commute_with_interpolation(roots):
    """coef targets == project(full targets): the bilinear frame
    interpolation commutes with the affine projection."""
    _, full = _readers(roots, False)
    _, pca = _readers(roots, False, TARGETS["pca"])
    for i in (0, 5, len(full) - 1):
        it_f, it_p = full[i], pca[i]
        frame = np.zeros((N_TRIS, 9), np.float32)
        frame[:, :6], frame[:, 6:] = it_f["dgrad_3d_scale_0"][0], it_f["dgrad_3d_rotat_0"][0]
        proj = pca._project_frames(frame.reshape(1, -1))[0]
        got = np.concatenate([it_p["dgrad_3d_scale_coef_0"][0], it_p["dgrad_3d_rotat_coef_0"][0]])
        np.testing.assert_allclose(got, proj, atol=1e-4)
        assert it_f["anime_weight_0"] == pytest.approx(it_p["anime_weight_0"])


def _graft_pitch_variants(root):
    """The ±2/±4-semitone source variants the VOCASET preprocessing writes with
    pitch_variants=True, made here by the JAX package's pitch shift."""
    from sdfa_tpu.audio import dsp

    for path in glob.glob(os.path.join(root, "data", "*", "*", "*_audio.npz")):
        blob = dict(np.load(path))
        for sfx, steps in (("u4", 4), ("u2", 2), ("d2", -2), ("d4", -4)):
            blob[f"audio_ps_{sfx}"] = dsp.pitch_shift(blob["audio"], int(blob["sr"]), steps)
            blob[f"audio_8k_ps_{sfx}"] = dsp.pitch_shift(blob["audio_8k"], 8000, steps)
        np.savez(path, **blob)


def test_pitch_shift_sources_give_the_same_batches(roots, tmp_path):
    pitch = {"audio": {"feature": {"random_pitch_shift": True}}}
    _, tds = _readers(roots, True, pitch)
    with pytest.raises(KeyError, match="pitch_variants=True"):
        tds[0]
    copies = tuple(shutil.copytree(r, str(tmp_path / name)) for r, name in zip(roots, "jt"))
    for root in copies:
        _graft_pitch_variants(root)
    jds, tds = _readers(copies, True, pitch)
    _assert_same_batches(list(itertools.islice(jds.batches(3), 3)),
                         list(itertools.islice(tds.batches(3), 3)))
    _assert_same_batches(list(itertools.islice(jds.raw_batches(3), 3)),
                         list(itertools.islice(tds.raw_batches(3), 3)))


@pytest.mark.parametrize("option", ["random_reverb", "random_time_stretch"])
def test_unsupported_source_variants_raise(roots, option):
    for reader, configure, root in ((JReader, jconfigure, roots[0]),
                                    (TReader, tconfigure, roots[1])):
        hp = configure("dgrad", dataset_root=root,
                       overrides={"audio": {"feature": {option: True}}})
        with pytest.raises(NotImplementedError, match=option):
            reader(hp, training=True)


@pytest.mark.parametrize("seconds,seed", [(0.3, 0), (1.0, 1), (2.35, 2)])
def test_fetch_audio_features_matches_jax(roots, seconds, seed):
    rng = np.random.default_rng(seed)
    sig = (0.2 * rng.normal(size=int(8000 * seconds))).clip(-1, 1).astype(np.float32)
    want = JReader.fetch_audio_features(sig, jconfigure("dgrad", dataset_root=roots[0]))
    got = TReader.fetch_audio_features(sig, tconfigure("dgrad", dataset_root=roots[1]))
    assert got["tslist"] == want["tslist"]
    assert set(np.diff(got["tslist"]).tolist()) <= {16, 17}  # one 60 fps frame apart
    assert got["audio_feat"].shape == want["audio_feat"].shape
    assert got["audio_feat"].shape[1:] == (64, 128, 3)
    np.testing.assert_allclose(got["audio_feat"], want["audio_feat"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=0, atol=1e-7)


def test_host_frontend_task_matches_jax(tmp_path):
    """``AnimationTask(device_frontend=False)`` answers through the reader's
    host features on both sides: vertices within 1e-5 m of the JAX task's."""
    from sdfa_tpu.task import AnimationTask as JTask
    from sdfa_tpu_torch.task import AnimationTask as TTask
    from test_torch_slice import _signal, task_pair

    sig = _signal(0.7, 4)
    with task_pair(tmp_path, narrow=True) as (jtask, ttask, n_verts):
        jhost = JTask(jtask.hp, jtask.model, jtask.variables, device_frontend=False)
        thost = TTask(ttask.hp, ttask.model, "cpu", device_frontend=False)
        assert not thost.overlap_frontend and not jhost.overlap_frontend
        ts_j, v_j = jhost.generate_vertices(sig, 2)
        ts_t, v_t = thost.generate_vertices(sig, 2)
        assert list(ts_t) == list(ts_j)
        assert v_t.shape == np.asarray(v_j).shape == (len(ts_t), n_verts, 3)
        assert float(np.abs(v_t - np.asarray(v_j)).max()) <= 1e-5
        # the per-window features came from the host reader: a repeat hits the cache
        assert thost._signal_cache[1][0]["audio_feat"].dtype == np.float32


def test_device_inference_features_match_the_host_reader(roots):
    """The serving frontend on the device against the reader's host features
    (``tests/test_data_pipeline.py::TestDevicePipelineParity``)."""
    import torch

    from sdfa_tpu_torch.audio.pipeline import WindowSpec, fetch_audio_features_device

    hp = tconfigure("dgrad", dataset_root=roots[1])
    rng = np.random.default_rng(0)
    sig = (0.2 * rng.normal(size=6000)).clip(-1, 1).astype(np.float32)
    host = TReader.fetch_audio_features(sig, hp)
    with torch.no_grad():
        dev = fetch_audio_features_device(sig, WindowSpec(hp), "cpu")
    assert host["tslist"] == dev["tslist"]
    got = dev["audio_feat"].numpy()
    assert got.shape == host["audio_feat"].shape
    np.testing.assert_allclose(got, host["audio_feat"], atol=2e-3)
    np.testing.assert_allclose(got[..., 0], host["audio_feat"][..., 0], atol=2e-4)


def _narrow_loss(batch):
    """Total loss of the narrow network of ``tests/test_torch_train_step.py`` in
    eval mode on ``batch``."""
    import torch

    from sdfa_tpu_torch.config import ConfigDict
    from sdfa_tpu_torch.train.trainer import SCALER_NAMES, make_loss_fn
    from sdfa_tpu_torch.models import losses as L
    from test_torch_train_step import _hparams, _torch_model

    torch.manual_seed(0)
    model = _torch_model().eval()
    for p in model.parameters():
        if p.requires_grad:
            torch.nn.init.normal_(p, 0, 0.2)
    loss_fn = make_loss_fn(model, ConfigDict(_hparams()))
    scalers = {n: L.ScalerState.init("cpu") for n in SCALER_NAMES}
    with torch.no_grad():
        total, aux = loss_fn(scalers, {k: torch.as_tensor(v) for k, v in batch.items()}, False)
    return float(total), {k: float(v) for k, v in aux["scalars"].items()}


def test_coef_targets_give_the_loss_of_their_decoded_targets():
    """loss(PCA-coefficient batch) == loss(the batch whose targets are the
    coefficients decoded on the host): the decode inside the loss is the
    model's own PCA inversion (``tests/test_pca_targets.py``)."""
    from test_torch_train_step import _batch, _pca

    coef = _batch(5, coef=True)
    (comp_s, mean_s), (comp_r, mean_r) = _pca()["scale"], _pca()["rotat"]
    full = {k: v for k, v in coef.items() if "_coef" not in k}
    full["dgrad_3d_scale"] = (coef["dgrad_3d_scale_coef"] @ comp_s.T + mean_s).reshape(8, 1, -1, 6)
    full["dgrad_3d_rotat"] = (coef["dgrad_3d_rotat_coef"] @ comp_r.T + mean_r).reshape(8, 1, -1, 3)
    t_coef, s_coef = _narrow_loss(coef)
    t_full, s_full = _narrow_loss(full)
    assert t_coef == pytest.approx(t_full, rel=1e-5)
    for key in s_full:
        assert s_coef[key] == pytest.approx(s_full[key], rel=1e-4), key


def test_f16_targets_change_the_loss_only_at_f16_resolution():
    """trainer.compact_targets ships f16 targets; the loss casts them back
    (``tests/test_data_pipeline.py::TestCompactTargets``)."""
    from test_torch_train_step import _batch

    b32 = _batch(6, coef=False)
    b16 = dict(b32, dgrad_3d_scale=b32["dgrad_3d_scale"].astype(np.float16),
               dgrad_3d_rotat=b32["dgrad_3d_rotat"].astype(np.float16))
    t32, t16 = _narrow_loss(b32)[0], _narrow_loss(b16)[0]
    assert t32 != t16 and abs(t32 - t16) < 2e-3 * max(1.0, abs(t32))
