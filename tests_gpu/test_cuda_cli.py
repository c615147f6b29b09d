"""``python -m sdfa_tpu_torch evaluate`` in process on the card (the port's
counterpart of ``evaluate.sh``): the shipped dgrad model at full width, seeded
weights and PCA bases over a small synthetic template written to disk, a 1 s
wav, once through the kernels and once through ``ops.plain_versions()``; the
exported meshes agree within 1e-5 m, with ``freq_lstm`` and ``bilstm2``
launched and ``decode_solve`` not (evaluate solves through
``frames_to_meshes``)."""

import os

import numpy as np
import pytest
import torch

from sdfa_tpu_torch import ops
from sdfa_tpu_torch.__main__ import main
from sdfa_tpu_torch.audio import io as audio_io
from sdfa_tpu_torch.compat import init_params
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.mesh import read_obj, synthetic_template, write_ply
from sdfa_tpu_torch.models import build_model
from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm
from sdfa_tpu_torch.viewer import frame

pytestmark = pytest.mark.gpu


def test_evaluate_cli_matches_plain(cuda, tmp_path):
    verts, faces, cnst = synthetic_template(1, n_major=10, n_minor=12, n_extra=5, n_free=50)
    n = len(faces)
    hp = configure("dgrad", overrides={"model": {"output": {"output_dim_scale": 6 * n,
                                                            "output_dim_rotat": 3 * n}}})
    rng = np.random.default_rng(0)
    pca = {"scale_compT": rng.normal(0, 0.02, (6 * n, 85)),
           "scale_means": rng.normal(0, 0.02, 6 * n),
           "rotat_compT": rng.normal(0, 0.02, (3 * n, 180)),
           "rotat_means": rng.normal(0, 0.02, 3 * n)}
    model = init_params(build_model(hp, pca=pca), 0)
    hp.dump(str(tmp_path / "hparams.json"))
    torch.save({"model": model.state_dict()}, str(tmp_path / "last.ckpt"))
    write_ply(str(tmp_path / "template.ply"), verts, faces)
    (tmp_path / "cnst.txt").write_text(" ".join(str(int(i)) for i in cnst))
    t = np.arange(8000) / 8000
    audio_io.save(str(tmp_path / "clip.wav"), 0.3 * np.sin(2 * np.pi * 150 * t), 8000)
    args = ["evaluate", "--custom_hparams", str(tmp_path / "hparams.json"),
            "--load_from", str(tmp_path / "last.ckpt"), "--eval_input", str(tmp_path / "clip.wav"),
            "--eval_spk_cond", "m0", "--template_mesh", str(tmp_path / "template.ply"),
            "--mesh_constraints", str(tmp_path / "cnst.txt"), "--no-save_video"]
    saved = dict(frame._state)
    try:
        freq_lstm.LAUNCHES.clear()
        decode_solve.LAUNCHES.clear()
        bilstm2.LAUNCHES.clear()
        main(args + ["--output_dir", str(tmp_path / "kernels")])
        launches = (freq_lstm.LAUNCHES.total(), bilstm2.LAUNCHES.total(),
                    decode_solve.LAUNCHES.total())
        with ops.plain_versions():
            main(args + ["--output_dir", str(tmp_path / "plain")])
    finally:
        frame._state.clear()
        frame._state.update(saved)
    assert launches[0] >= 1 and launches[1] >= 1 and launches[2] == 0, launches
    objs = sorted(f for f in os.listdir(tmp_path / "kernels" / "clip") if f.endswith(".obj"))
    assert objs and objs == sorted(
        f for f in os.listdir(tmp_path / "plain" / "clip") if f.endswith(".obj"))
    got = np.stack([read_obj(str(tmp_path / "kernels" / "clip" / f), np.float64)[0] for f in objs])
    want = np.stack([read_obj(str(tmp_path / "plain" / "clip" / f), np.float64)[0] for f in objs])
    assert got.shape == (len(objs), len(verts), 3) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5
