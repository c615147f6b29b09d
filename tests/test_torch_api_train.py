"""``api.train_model`` of the port end to end on the CPU, at the full width of
the shipped ``dgrad`` model, on a dataset generated at FLAME's counts: the
whole wiring (dataset → loaders, with and without the thread prefetch, raw
mode and host features → Experiment → Trainer → checkpoint), capped to a few
tiny steps; then the trained checkpoint restored and served. Mirrors
``tests/test_api_train.py``; the step itself is held to the JAX package's in
``tests/test_torch_device_features.py`` (raw mode) and
``tests/test_torch_train_step.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from sdfa_tpu_torch import api
from sdfa_tpu_torch.data import synthetic
from sdfa_tpu_torch.ops import decode_solve as K3
from sdfa_tpu_torch.train import checkpoints

SMALL = dict(anime_loader=dict(batch_size=2))


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("api_train") / "voca")
    synthetic.generate(root, "dgrad_3d", speakers=["m0", "f0"], sentences_per_speaker=1,
                       seconds_per_sentence=2.0)
    return root


def _timing(log_dir):
    with open(os.path.join(log_dir, "train_log", "metrics.jsonl")) as fp:
        return [rec for rec in map(json.loads, fp) if rec["tag"] == "timing"]


@pytest.fixture(scope="module")
def trained(synth_root, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("run") / "run")
    exp = api.train_model("dgrad", dataset_root=synth_root, log_dir=log_dir, max_steps=2,
                          overrides=dict(trainer=dict(pca_targets=True, **SMALL)), device="cpu")
    return exp, log_dir


def test_train_model_end_to_end(trained):
    exp, log_dir = trained
    assert exp.step == 2 and exp.epoch == 1  # max_steps caps the run: epoch 2 had no batch
    for name in ("last.ckpt", "params_info.txt", "hparams.json"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    assert open(os.path.join(log_dir, "params_info.txt")).read().splitlines()[-1] \
        == "TOTAL: 6979762"
    (timing,) = _timing(log_dir)
    assert timing["steps"] == 2 and 0 <= timing["loader_wait_s"] <= timing["wall_s"]
    rows = open(os.path.join(log_dir, "train_log", "loss", "epoch-loss.csv")).read().splitlines()
    assert len(rows) == 2
    header, values = rows[0].split(","), rows[1].split(",")
    assert all(np.isfinite(float(v)) for k, v in zip(header, values) if k != "epoch")


def test_train_model_thread_prefetch_can_be_disabled(synth_root, tmp_path):
    exp = api.train_model("dgrad", dataset_root=synth_root, log_dir=str(tmp_path / "run"),
                          max_steps=1, device="cpu",
                          overrides=dict(trainer=dict(pca_targets=True, thread_prefetch=False,
                                                      **SMALL)))
    assert exp.step == 1


def test_train_model_host_features(synth_root, tmp_path):
    """trainer.host_features: the host feature path in the loop (full
    dgrad targets, no PCA projection)."""
    exp = api.train_model("dgrad", dataset_root=synth_root, log_dir=str(tmp_path / "run"),
                          max_steps=1, device="cpu",
                          overrides=dict(trainer=dict(host_features=True, **SMALL)))
    assert exp.step == 1
    assert os.path.exists(tmp_path / "run" / "last.ckpt")


@pytest.mark.parametrize("option", ["random_mel_noise", "random_mel_tremolo"])
def test_raw_mode_refuses_what_the_device_frontend_lacks(synth_root, tmp_path, option):
    with pytest.raises(NotImplementedError, match=option):
        api.train_model("dgrad", dataset_root=synth_root, log_dir=str(tmp_path / "run"),
                        max_steps=1, device="cpu",
                        overrides=dict(audio=dict(feature={option: 0.1}),
                                       trainer=dict(pca_targets=True, **SMALL)))


def test_train_model_resumes_from_a_checkpoint_name(trained, synth_root):
    """``load_from`` resolves a bare name against the run directory, as the
    JAX API does, and the run goes on from the saved step."""
    _, log_dir = trained
    exp = api.train_model("dgrad", dataset_root=synth_root, log_dir=log_dir, load_from="last",
                          max_steps=1, device="cpu",
                          overrides=dict(trainer=dict(pca_targets=True, max_epochs=2, **SMALL)))
    assert (exp.step, exp.epoch) == (3, 2)


def test_trained_checkpoint_serves_with_the_dataset_bases(trained, synth_root):
    """The trained weights restored into ``build_model`` with the dataset's
    fitted PCA bases and served over a synthetic template at FLAME's counts:
    sampled frames within 1e-4 m of the float64 decode + solve."""
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import synthetic_template
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.viewer import frame

    _, log_dir = trained
    hp = configure("dgrad", dataset_root=synth_root)
    model = build_model(hp)
    model.load_state_dict(checkpoints.load_checkpoint(os.path.join(log_dir, "last.ckpt"))["model"])
    assert torch.equal(model.scale_pca.compT, torch.from_numpy(
        np.load(os.path.join(synth_root, "pca", "scale_compT.npy"))))
    saved = dict(frame._state)
    try:
        solver = frame.set_template_mesh(*synthetic_template(0))
        task = AnimationTask(hp, model, "cpu")
        rng = np.random.default_rng(1)
        sig = (0.3 * np.sin(np.arange(4800) * 0.11) + 0.02 * rng.normal(size=4800)) \
            .clip(-1, 1).astype(np.float32)
        ts, verts = task.generate_vertices(sig, "f0")
        assert verts.shape == (len(ts), 5023, 3) and np.isfinite(verts).all()
        sample = [0, len(ts) // 2, len(ts) - 1]
        with torch.no_grad():
            frame_idx, _, z, _ = task._overlap_prefix(sig)
            preds, _, _ = model.forward_windows(z, torch.from_numpy(frame_idx[sample]).long(),
                                                torch.ones(len(sample), dtype=torch.long),
                                                raw_pca=True)
            _, _, dsc = task._decode_consts()
            dt = K3.delta_transforms(preds["dgrad_3d_scale_pca"][:, 0],
                                     preds["dgrad_3d_rotat_pca"][:, 0], dsc)
        assert bool(torch.isfinite(dt).all())
        c = {n: preds[f"dgrad_3d_{n}_pca"][:, 0].double().numpy() for n in ("scale", "rotat")}
        dec = [c[n] @ getattr(model, f"{n}_pca").compT.double().numpy().T
               + getattr(model, f"{n}_pca").means.double().numpy() for n in ("scale", "rotat")]
        frames = np.concatenate([dec[0].reshape(len(sample), -1, 6),
                                 dec[1].reshape(len(sample), -1, 3)], axis=-1)
        oracle = np.stack([solver.solve_host(f) for f in frames])
        assert float(np.abs(verts[sample] - oracle).max()) <= 1e-4
    finally:
        frame._state.clear()
        frame._state.update(saved)
