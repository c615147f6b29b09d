"""``api.load_task``, ``trace_model`` and ``load_traced`` of the port (after
``tests/test_task.py``'s ``TestLoadTask`` and ``TestTracedRoundTrip``): a
checkpoint in a run directory and a trace dump each rebuild a task whose
requests equal the live model's, with no dataset and nothing written; a run
directory without ``hparams.json`` and a JAX msgpack checkpoint are refused.
The dgrad network at narrow widths over a small synthetic template
(``test_torch_slice.py::task_pair``), on the CPU."""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_slice import _signal, task_pair

from sdfa_tpu_torch import api
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.task import AnimationTask
from sdfa_tpu_torch.train import Experiment

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL_M = 1e-6  # the same weights through the same code: 0 is expected


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A port run directory (``Experiment``: hparams.json + last.ckpt) of a
    seeded narrow model, and the live model it saved."""
    root = tmp_path_factory.mktemp("load_task")
    with task_pair(root, narrow=True) as (_, ttask, n_verts):
        run_dir = str(root / "run")
        exp = Experiment(ttask.hp, build_model(ttask.hp), run_dir, "cpu", seed=3)
        exp.save()
        yield root, run_dir, exp.model.eval(), n_verts


def _request(task, seconds=0.7, speaker=1):
    return task.generate_vertices(_signal(seconds, 7), speaker)


def test_ckpt_to_task_roundtrip(run):
    """The run's checkpoint served through load_task gives the live model's
    vertices; the PCA bases come from the checkpoint, not the dataset."""
    root, run_dir, model, n_verts = run
    live = AnimationTask(_hp(run_dir), model, "cpu")
    ts_want, want = _request(live)
    os.rename(root / "pca", root / "pca_away")  # no dataset to read
    try:
        task = api.load_task(os.path.join(run_dir, "last.ckpt"), device="cpu")
    finally:
        os.rename(root / "pca_away", root / "pca")
    assert task.device == torch.device("cpu")
    ts_got, got = _request(task)
    assert list(ts_got) == list(ts_want) and got.shape == (len(ts_want), n_verts, 3)
    assert float(np.abs(got - want).max()) <= TOL_M


def _hp(run_dir):
    from sdfa_tpu_torch.config import ConfigDict

    return ConfigDict.parse_file(os.path.join(run_dir, "hparams.json"))


def test_missing_hparams_raises(tmp_path):
    """A bare checkpoint without hparams.json fails loudly instead of building
    the default config's model."""
    ckpt = tmp_path / "orphan.ckpt"
    ckpt.write_bytes(b"\x00")
    with pytest.raises(FileNotFoundError, match="hparams.json"):
        api.load_task(str(ckpt), device="cpu")


def test_read_only_run_dir(run):
    """load_task is a pure reader: no ``_state/`` and nothing else written
    beside the checkpoint (serving mounts are read-only)."""
    _, run_dir, _, _ = run
    before = sorted(os.listdir(run_dir))
    os.chmod(run_dir, 0o555)
    try:
        task = api.load_task(os.path.join(run_dir, "last.ckpt"), device="cpu")
    finally:
        os.chmod(run_dir, 0o755)
    assert sorted(os.listdir(run_dir)) == before and "_state" not in before
    assert task.model.face_type == "dgrad_3d"


def test_msgpack_checkpoint_is_refused(run, tmp_path):
    """A JAX (flax msgpack) checkpoint cannot be read by the port: refused with
    a message that says so."""
    import flax.serialization as fser

    _, run_dir, _, _ = run
    shutil.copy(os.path.join(run_dir, "hparams.json"), tmp_path / "hparams.json")
    (tmp_path / "jax.ckpt").write_bytes(fser.to_bytes({"params": {"w": np.zeros(3, np.float32)}}))
    with pytest.raises(ValueError, match="msgpack"):
        api.load_task(str(tmp_path / "jax.ckpt"), device="cpu")


def test_trace_then_load_traced_matches_live(run, tmp_path):
    """trace_model's dump (hparams.json + model.pt) alone rebuilds a task whose
    requests equal the live model's."""
    _, run_dir, model, _ = run
    dump = api.trace_model(custom_hparams=os.path.join(run_dir, "hparams.json"),
                           load_from=os.path.join(run_dir, "last.ckpt"),
                           traced_dump_path=str(tmp_path / "dump"), device="cpu")
    assert sorted(os.listdir(dump)) == ["hparams.json", "model.pt"]
    state = torch.load(os.path.join(dump, "model.pt"), weights_only=True)
    assert state.keys() == {"model"} and state["model"].keys() == model.state_dict().keys()
    ts_got, got = _request(api.load_traced(dump, device="cpu"), 0.9, 0)
    ts_want, want = _request(AnimationTask(_hp(run_dir), model, "cpu"), 0.9, 0)
    assert list(ts_got) == list(ts_want)
    assert float(np.abs(got - want).max()) <= TOL_M
