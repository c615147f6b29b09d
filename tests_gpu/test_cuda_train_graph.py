"""The one-card train step as a CUDA graph (``train/trainer.py::StepGraph``)
against the same step run eagerly, on the narrow dgrad-type network of
``test_cuda_parallel.py`` (K5 at H = 128: 3 forward and 3 backward launches a
step; dropout 0.3 between the LSTM layers, so the dropout generator's draws
are compared too). Both experiments run the capturable Adam of a one-card
``Experiment``; the eager one steps inside ``ops.count_costs()``, which a
replay cannot serve (``graph_refusal``: ``mode``). cuDNN picks deterministic
algorithms here, so that two eager runs are equal bit for bit and the graph
is held to that."""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_cuda_parallel import HPARAMS, MODEL_ARGS, MODEL_KWARGS, SEED, _batch

from sdfa_tpu_torch import ops
from sdfa_tpu_torch.compat import init_params
from sdfa_tpu_torch.config import ConfigDict
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation
from sdfa_tpu_torch.ops import bilstm_core
from sdfa_tpu_torch.train import Experiment, checkpoints, trainer

pytestmark = pytest.mark.gpu

STEPS = 5
K5_NAMES = ("core_bwd_kernel", "steps_kernel")  # K5's backward and forward kernels


@pytest.fixture
def card(cuda):
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = saved


def _state():
    model = init_params(SpeechDrivenAnimation(*MODEL_ARGS, **MODEL_KWARGS), 3)
    rng = np.random.default_rng(99)
    with torch.no_grad():
        for name in ("scale_pca", "rotat_pca"):
            pca = getattr(model, name)
            pca.compT.copy_(torch.from_numpy(rng.normal(0, 0.1, pca.compT.shape)))
            pca.means.copy_(torch.from_numpy(rng.normal(0, 0.01, pca.means.shape)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _experiment(tmp_path, name, state, load_from=None, hparams=HPARAMS):
    exp = Experiment(ConfigDict(hparams), SpeechDrivenAnimation(*MODEL_ARGS, **MODEL_KWARGS),
                     str(tmp_path / name), "cuda", seed=SEED)
    exp.model.load_state_dict(state)
    if load_from:
        exp.load(load_from)
    return exp


def _eager(exp, batch):
    with ops.count_costs():
        return exp.train_step(batch)


def _held(exp):
    """Every tensor of the experiment's state, by name, on the host."""
    out = {f"model.{k}": v for k, v in exp.model.state_dict().items()}
    for i, p in enumerate(exp.params):
        for k, v in exp.optimizer.state.get(p, {}).items():
            out[f"adam.{i}.{k}"] = v
        if p.grad is not None:
            out[f"grad.{i}"] = p.grad
    for n, s in exp.scalers.items():
        out[f"scaler.{n}.vt"], out[f"scaler.{n}.beta_t"] = s
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def _differ(a, b):
    assert sorted(a) == sorted(b)
    return [k for k in a if not torch.equal(a[k], b[k])]


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    return [k for k in want if (got[k] != want[k] if k == "lr"
                                else not torch.equal(got[k], want[k]))]


# lr and beta1 both change at every step (beta1 0.9, 0.833, ..., 0.633)
NOAM_ZERO = {**HPARAMS, "optim": dict(name="Adam", args=dict(lr=1e-4, weight_decay=0),
                                      lr_scheduler=dict(name="NoamZero", args=dict(
                                          mode="step", warmup_iters=1, start_ramp=2,
                                          total_iters=8)))}


@pytest.mark.parametrize("hparams", [HPARAMS, NOAM_ZERO], ids=["constant", "beta1-schedule"])
def test_graph_steps_equal_eager_steps_bit_for_bit(card, tmp_path, hparams):
    state = _state()
    graphed = _experiment(tmp_path, "graph", state, hparams=hparams)
    eager = _experiment(tmp_path, "eager", state, hparams=hparams)
    control = _experiment(tmp_path, "control", state, hparams=hparams)
    assert (graphed._beta1 is not None) == (hparams is NOAM_ZERO)
    batches = [_batch(20 + i) for i in range(STEPS)]
    beta1 = []
    steps0 = collections.Counter(trainer.GRAPH_STEPS)
    for i, batch in enumerate(batches):
        got = graphed.train_step(batch)
        beta1.append(float(graphed.optimizer.param_groups[0]["betas"][0]))
        want = _eager(eager, batch)
        again = _eager(control, batch)
        assert not _same_metrics(again, want), f"two eager runs differ at step {i}"
        assert not _same_metrics(got, want), (i, _same_metrics(got, want))
    torch.cuda.synchronize()
    assert trainer.GRAPH_STEPS - steps0 == {"capture": 1, "replay": STEPS,
                                            "eager:mode": 2 * STEPS}
    want = _held(eager)
    assert not _differ(_held(control), want)
    # losses and grad_norm above; parameters, BatchNorm's buffers, Adam's moments
    # and step counts, the gradients and the scalers here
    assert not _differ(_held(graphed), want), _differ(_held(graphed), want)
    assert graphed.scalers is graphed._graph.scalers
    assert len(set(beta1)) == (1 if hparams is HPARAMS else STEPS), beta1


def test_capture_leaves_every_state_tensor_as_it_was(card, tmp_path):
    state = _state()
    for warm in (0, 1):  # a fresh Adam, then one with state from an eager step
        exp = _experiment(tmp_path, f"warm{warm}", state)
        for i in range(warm):
            _eager(exp, _batch(40 + i))
        batch = exp.put_batch(_batch(50))
        exp._lr.fill_(1e-4)
        exp.dropout_gen.manual_seed(77)
        before, tally = _held(exp), ops.launch_tally()
        graph = exp._capture(batch, trainer.step_signature(batch))
        torch.cuda.synchronize()
        assert graph.graph is not None
        after = _held(exp)
        grads = [k for k in after if k.startswith("grad.")]
        for k in grads:  # the graph's own gradients, written at the first replay
            after.pop(k)
            before.pop(k, None)
        if not warm:  # Adam's state made by the warm-up is a fresh Adam's: zeros, step 0
            made = {k: after.pop(k) for k in list(after) if k.startswith("adam.")}
            assert made and all(not v.any() for v in made.values())
        assert not _differ(after, before), _differ(after, before)
        assert exp.dropout_gen.initial_seed() == 77
        assert ops.launch_tally() == tally
        assert graph.launches[(bilstm_core.__name__, "FWD_LAUNCHES")] == 3


def test_another_batch_size_runs_eagerly(card, tmp_path):
    state = _state()
    graphed = _experiment(tmp_path, "graph", state)
    eager = _experiment(tmp_path, "eager", state)
    steps0 = collections.Counter(trainer.GRAPH_STEPS)
    for i, bsz in enumerate((8, 4, 8, 8)):
        batch = _batch(60 + i, bsz=bsz)
        got = graphed.train_step(batch)
        want = _eager(eager, batch)
        assert not _same_metrics(got, want), (i, bsz, _same_metrics(got, want))
    assert trainer.GRAPH_STEPS - steps0 == {"capture": 1, "replay": 3, "eager:signature": 1,
                                            "eager:mode": 4}
    # the replay after the eager step gave the parameters the graph's gradients again
    assert all(p.grad is g for p, g in zip(graphed.params, graphed._graph.grads))
    assert not _differ(_held(graphed), _held(eager))


def test_k5_launch_counters_match_the_eager_path(card, tmp_path):
    state = _state()
    counts = {}
    for name in ("graph", "eager"):
        exp = _experiment(tmp_path, name, state)
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        bilstm_core.LAUNCHES_BY_HIDDEN.clear()
        for i in range(STEPS):
            (exp.train_step if name == "graph" else lambda b: _eager(exp, b))(_batch(70 + i))
        counts[name] = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES,
                        dict(bilstm_core.LAUNCHES_BY_HIDDEN))
    assert counts["graph"] == counts["eager"] == (3 * STEPS, 3 * STEPS,
                                                  {("fwd", 128): 3 * STEPS,
                                                   ("bwd", 128): 3 * STEPS})


def test_profiler_sees_the_replayed_kernels_by_name(card, tmp_path):
    """A ``torch.profiler`` trace of replays holds K5's kernels under their
    names, as many a step as the eager path's, and one ``train/graph_replay``
    span a step: what the benchmark's device metrics read."""
    state = _state()
    found = {}
    for name in ("graph", "eager"):
        exp = _experiment(tmp_path, name, state)
        step = exp.train_step if name == "graph" else (lambda b: _eager(exp, b))
        step(_batch(80))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                step(_batch(81 + i))
            torch.cuda.synchronize()
        path = str(tmp_path / f"{name}.json")
        prof.export_chrome_trace(path)
        with open(path) as fp:
            events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
        found[name] = (collections.Counter(k for e in events for k in K5_NAMES
                                           if e.get("cat") == "kernel" and k in e["name"]),
                       sum(e["name"] == "train/graph_replay" for e in events
                           if e.get("cat") == "user_annotation"))
    assert found["graph"][0] == found["eager"][0] and sum(found["graph"][0].values()) == 12
    assert found["graph"][1] == 2 and found["eager"][1] == 0


def test_load_drops_the_graph(card, tmp_path):
    state = _state()
    exp = _experiment(tmp_path, "run", state)
    for i in range(2):
        exp.train_step(_batch(90 + i))
    path = exp.save()
    payload = checkpoints.load_checkpoint(path)
    group = payload["optimizer"]["param_groups"][0]
    assert isinstance(group["lr"], float) and group["capturable"] is False
    assert all(isinstance(b, float) for b in group["betas"]) and group["foreach"] is None
    assert all(s["step"].device.type == "cpu" for s in payload["optimizer"]["state"].values())
    assert exp._graph is not None
    exp.load(path)
    assert exp._graph is None
    assert all(s["step"].device.type == "cuda" for s in exp.optimizer.state.values())
    steps0 = collections.Counter(trainer.GRAPH_STEPS)
    eager = _experiment(tmp_path, "eager", state, load_from=path)
    for i in range(2):
        got = exp.train_step(_batch(92 + i))
        want = _eager(eager, _batch(92 + i))
        assert not _same_metrics(got, want), (i, _same_metrics(got, want))
    assert trainer.GRAPH_STEPS - steps0 == {"capture": 1, "replay": 2, "eager:mode": 2}
    assert not _differ(_held(exp), _held(eager))


def test_a_capture_that_fails_leaves_the_steps_eager(card, tmp_path, monkeypatch):
    """A step body that reads a value back to the host cannot be captured:
    the capture raises, the state is put back, and this step and the next of
    the signature run eagerly (``eager:capture``), equal to an eager run."""
    state = _state()
    exp = _experiment(tmp_path, "run", state)
    eager = _experiment(tmp_path, "eager", state)
    body = exp._graph_body

    def reads_back(inputs, scalers):
        out = body(inputs, scalers)
        float(out[0][0])  # a synchronizing read: the stream capture refuses it
        return out

    monkeypatch.setattr(exp, "_graph_body", reads_back)
    steps0 = collections.Counter(trainer.GRAPH_STEPS)
    for i in range(2):
        got = exp.train_step(_batch(100 + i))
        want = _eager(eager, _batch(100 + i))
        assert not _same_metrics(got, want), (i, _same_metrics(got, want))
    assert trainer.GRAPH_STEPS - steps0 == {"capture": 1, "eager:capture": 2, "eager:mode": 2}
    assert exp._graph.graph is None
    assert not _differ(_held(exp), _held(eager))
