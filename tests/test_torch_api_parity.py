"""``api.train_model`` of the port against the JAX package's, each on a root
of its own generator (the two write equal arrays from one seed,
``tests/test_torch_data.py``). Both runs start from the same weights (the JAX
run's initial variables, loaded into the port's model) and read the same
batches (the two readers agree bit for bit, ibid.), in raw mode with the
thread prefetch, at the full width of the shipped ``dgrad`` model with the
time LSTM's dropout set to 0 (the two frameworks' random streams cannot
match). Held: every loss term and the lr of both steps, 1e-5 relative
(``tests/test_torch_train_step.py``'s budget: f32 on both sides, sums in
another order); the gradient norm, 1e-3 (see ``GRAD_NORM_RTOL``)."""

import pytest

import jax

from sdfa_tpu import api as japi
from sdfa_tpu.data import synthetic as jsynthetic
from sdfa_tpu_torch import api as tapi
from sdfa_tpu_torch.compat import load_flax_variables
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import synthetic as tsynthetic

STEPS = 2
# The first conv's bias feeds BatchNorm, so its true gradient is zero; what each
# side computes is the rounding of a sum of 2·4·64·126 terms, about 0.1 in norm
# on either side against a whole gradient of about 3, and moves the norm by 3e-4.
# The loss terms do not see it (BatchNorm takes the bias out again).
GRAD_NORM_RTOL = 1e-3


def _overrides():
    layers = [tuple("dropout=0.0" if arg == "dropout=0.1" else arg for arg in layer)
              for layer in configure("dgrad").model.audio_encoder.layers]
    assert sum("dropout=0.0" in layer for layer in layers) == 1
    # 2·4 windows a step: the batch splits evenly over the tests' 8 CPU devices,
    # so the JAX run keeps the batch size the port takes whole
    return dict(model=dict(audio_encoder=dict(layers=layers)),
                trainer=dict(pca_targets=True, anime_loader=dict(batch_size=4)))


def test_train_model_steps_match_jax(tmp_path, monkeypatch):
    roots = [str(tmp_path / name / "voca") for name in ("jax", "port")]
    for generate, root in zip((jsynthetic.generate, tsynthetic.generate), roots):
        generate(root, "dgrad_3d", speakers=["m0", "f0"], sentences_per_speaker=1,
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
    japi.train_model("dgrad", dataset_root=roots[0], log_dir=str(tmp_path / "jax" / "run"),
                     max_steps=STEPS, overrides=_overrides())
    exp = tapi.train_model("dgrad", dataset_root=roots[1], log_dir=str(tmp_path / "port" / "run"),
                           max_steps=STEPS, overrides=_overrides(), device="cpu")
    assert exp.step == STEPS and len(want) == len(got) == STEPS
    for step, (w, g) in enumerate(zip(want, got)):
        assert sorted(g) == sorted(w)
        for key, val in w.items():
            rel = GRAD_NORM_RTOL if key == "grad_norm" else 1e-5
            assert float(g[key]) == pytest.approx(float(val), rel=rel, abs=1e-9), (step, key)
