"""``tools/longrun_train_torch.py`` against the JAX package's
``tools/longrun_train.py``: with each package's ``api.train_model``
replaced by a recorder, the two tools write the same dataset (every file,
array for array, bit for bit; cut to 60 triangles, as tests/test_torch_data.py
cuts it: the tools do not depend on the mesh) and make the same call,
``device`` aside: the card by default, the CPU with ``--platform cpu``.
Importing the JAX tool sets ``SDFA_MATMUL_PRECISION``, ``SDFA_OPS_PRECISION``
and ``JAX_COMPILATION_CACHE_DIR`` by ``os.environ.setdefault``: it is loaded
under ``monkeypatch.setenv``."""

import glob
import importlib.util
import os
import sys

import numpy as np
import pytest

import sdfa_tpu.api as japi
import sdfa_tpu.data.synthetic as jsynth
import sdfa_tpu_torch.api as tapi
from sdfa_tpu_torch.data import synthetic as tsynth

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path, monkeypatch, tmp_path):
    monkeypatch.setenv("SDFA_MATMUL_PRECISION", os.environ.get("SDFA_MATMUL_PRECISION", "high"))
    monkeypatch.setenv("SDFA_OPS_PRECISION", os.environ.get("SDFA_OPS_PRECISION", "high"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(monkeypatch, api):
    calls = []
    monkeypatch.setattr(api, "train_model", lambda *a, **kw: calls.append((a, kw)))
    return calls


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(root + "/**", recursive=True)
                  if os.path.isfile(p))


def _arrays(path):
    if path.endswith(".npz"):  # an .npz archive carries zip timestamps: its arrays
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".npy"):
        return {"": np.load(path)}
    return {"": open(path).read()}


def test_same_dataset_and_same_call(monkeypatch, tmp_path):
    for module in (jsynth, tsynth):
        monkeypatch.setattr(module, "N_TRIS", 60)
    jtool = _load("_jax_longrun", "tools/longrun_train.py", monkeypatch, tmp_path)
    ttool = _load("_torch_longrun", "tools/longrun_train_torch.py", monkeypatch, tmp_path)
    jcalls, tcalls = _recorder(monkeypatch, japi), _recorder(monkeypatch, tapi)
    common = ["--steps", "7", "--speakers", "3", "--sentences", "1", "--seconds", "0.5"]
    roots = {}
    for side, tool, extra in (("j", jtool, []), ("t", ttool, ["--platform", "cpu"])):
        roots[side] = str(tmp_path / side / "voca")
        argv = common + ["--run-dir", str(tmp_path / side / "run"), "--root", roots[side]]
        if side == "j":
            monkeypatch.setattr(sys, "argv", ["longrun_train.py"] + argv)
            tool.main()
        else:
            tool.main(argv + extra)
    files = _files(roots["j"])
    assert files == _files(roots["t"]) and len(files) > 50
    for rel in files:
        want, got = _arrays(os.path.join(roots["j"], rel)), _arrays(os.path.join(roots["t"], rel))
        assert sorted(want) == sorted(got), rel
        for key, value in want.items():
            if isinstance(value, str):  # the manifests name each root's own paths
                assert value.replace(roots["j"], roots["t"]) == got[key], rel
            else:
                assert value.dtype == got[key].dtype and np.array_equal(value, got[key]), rel
    assert len(jcalls) == len(tcalls) == 1
    (ja, jkw), (ta, tkw) = jcalls[0], tcalls[0]
    assert ta == ja == ("dgrad",)
    assert tkw.pop("device") == "cpu"
    for kw, side in ((jkw, "j"), (tkw, "t")):
        assert kw.pop("dataset_root") == roots[side]
        assert kw.pop("log_dir") == str(tmp_path / side / "run")
    assert tkw == jkw == {"max_steps": 7, "overrides": {
        "trainer": {"pca_targets": True, "max_epochs": 10 ** 6}}}


def test_card_by_default_and_refused_without_one(monkeypatch, tmp_path):
    import torch

    ttool = _load("_torch_longrun", "tools/longrun_train_torch.py", monkeypatch, tmp_path)
    calls = _recorder(monkeypatch, tapi)
    root = tmp_path / "voca"
    root.mkdir()
    (root / "train.csv").write_text("")  # an existing dataset is not generated again
    argv = ["--root", str(root), "--run-dir", str(tmp_path / "run")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(argv)
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ttool.main(argv)
    assert calls[0][1]["device"] == "cuda" and calls[0][1]["max_steps"] == 2500
    assert sorted(os.listdir(root)) == ["train.csv"]
