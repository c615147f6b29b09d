"""``api.train_model`` on the shipped offsets config (``configs/model/
offsets.py`` over ``configs/data/voca-offsets.py``), the port against the JAX
package, each on a root of its own generator (``synthetic.generate`` with
``verts_off_3d`` writes equal arrays on both sides from one seed): both runs
start from the same weights and read the same batches, in raw mode with the
thread prefetch and PCA-coefficient targets, at full width with the time
LSTM's dropout set to 0 (the two frameworks' random streams cannot match).
Held as in ``tests/test_torch_api_parity.py``: every loss term and the lr of
both steps 1e-5 relative, the gradient norm ``GRAD_NORM_RTOL`` (below); the
checkpoint holds the offsets model's one pair of loss scalers."""

import os

import pytest

import jax

from test_torch_api_parity import STEPS

from sdfa_tpu import api as japi
from sdfa_tpu.data import synthetic as jsynthetic
from sdfa_tpu_torch import api as tapi
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import synthetic as tsynthetic
from sdfa_tpu_torch.train import checkpoints

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


# As in tests/test_torch_api_parity.py, the first conv's bias feeds BatchNorm and
# its true gradient is zero. Here each side's rounding leaves more of it: 0.149
# of gradient norm on the JAX side, 0.061 on the port's, against a whole norm of
# 2.46, which moves the norm by 1.5e-3 of itself; every other parameter's
# gradient agreed within 3.5e-5 of the largest (a one-off per-parameter
# comparison on the CPU). The loss terms do not see it.
GRAD_NORM_RTOL = 5e-3


def _overrides():
    layers = [tuple("dropout=0.0" if arg == "dropout=0.1" else arg for arg in layer)
              for layer in configure("offsets").model.audio_encoder.layers]
    assert sum("dropout=0.0" in layer for layer in layers) == 1
    return dict(model=dict(audio_encoder=dict(layers=layers)),
                trainer=dict(pca_targets=True, anime_loader=dict(batch_size=4)))


def test_offsets_train_model_steps_match_jax(tmp_path, monkeypatch):
    roots = [str(tmp_path / name / "voca") for name in ("jax", "port")]
    for generate, root in zip((jsynthetic.generate, tsynthetic.generate), roots):
        generate(root, "verts_off_3d", speakers=["m0", "f0"], sentences_per_speaker=1,
                 seconds_per_sentence=2.0)
    start, want, got = {}, [], []

    class JaxRecording(japi.Trainer):
        """Keeps the run's initial variables and every step's metrics."""

        def __init__(self, exp, **kw):
            super().__init__(exp, **kw)
            state = jax.device_get(exp.state)
            start.update(params=state.params, batch_stats=state.batch_stats,
                         constants=state.constants)
            step_fn = exp.train_step_fn

            def recorded(*args):
                new_state, metrics = step_fn(*args)
                want.append(jax.device_get(metrics))
                return new_state, metrics

            exp.train_step_fn = recorded

    class PortRecording(tapi.Experiment):
        """Starts from the JAX run's variables and keeps every step's metrics."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            load_flax_variables(self.model, start)

        def train_step(self, batch):
            metrics = super().train_step(batch)
            got.append(metrics)
            return metrics

    monkeypatch.setattr(japi, "Trainer", JaxRecording)
    monkeypatch.setattr(tapi, "Experiment", PortRecording)
    japi.train_model("offsets", dataset_root=roots[0], log_dir=str(tmp_path / "jax" / "run"),
                     max_steps=STEPS, overrides=_overrides())
    run = str(tmp_path / "port" / "run")
    exp = tapi.train_model("offsets", dataset_root=roots[1], log_dir=run, max_steps=STEPS,
                           overrides=_overrides(), device="cpu")
    assert exp.model.face_type == "verts_off_3d" and tuple(exp.model.pca.compT.shape) == (
        15069, 59)
    assert exp.step == STEPS and len(want) == len(got) == STEPS
    for step, (w, g) in enumerate(zip(want, got)):
        assert sorted(g) == sorted(w) and "dyn_ploss" in g
        for key, val in w.items():
            rel = GRAD_NORM_RTOL if key == "grad_norm" else 1e-5
            assert float(g[key]) == pytest.approx(float(val), rel=rel, abs=1e-9), (step, key)

    ckpt = os.path.join(run, "last.ckpt")
    assert sorted(checkpoints.load_checkpoint(ckpt)["scalers"]) == ["dyn_e", "dyn_m", "dyn_p"]
