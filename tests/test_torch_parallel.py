"""Data-parallel training of the port (``sdfa_tpu_torch/parallel/``) on the CPU.

The helpers against the JAX package's; the pair-keeping shard (a contiguous
split of the doubled batch breaks the motion loss's pairs); the global draws
of dropout and multiplicative noise; ``maybe_initialize_distributed`` raising
where a launcher environment is present and the group cannot be joined; then
two gloo ranks, each a fresh interpreter (``tests/_torch_dist_worker.py``),
against one process (dropout on) and against the JAX step sharded over the 8
virtual CPU devices of ``tests/conftest.py`` (dropout off), and a two-rank
``api.train_model`` on a generated dataset.

Tolerances, those of ``tests/test_torch_train_step.py``: every metric within
rel 1e-5 / abs 1e-9, every ``state_dict`` entry (parameters and BatchNorm
statistics) and the scaler states within 1e-5 max abs; f32 on both sides,
sums in another order. The two ranks are bit-equal to each other."""

import datetime
import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist_worker import run_ranks
from test_torch_nn import _perturb
from test_torch_slice import narrow_model
from test_torch_train_step import KR, KS, N_TRIS, _batch, _hparams, _jax_model, _specs

from sdfa_tpu.models import losses as JL
from sdfa_tpu.parallel import mesh as jmesh
from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch import api
from sdfa_tpu_torch.compat import state_dict_from_flax
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.config import configure
from sdfa_tpu_torch.data import DatasetSlidingWindow, synthetic
from sdfa_tpu_torch.models import losses as L
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation as TModel
from sdfa_tpu_torch.nn.layers import MultiplicativeNoise, dropout
from sdfa_tpu_torch.parallel import Mesh, mesh, multihost, pad_batch_to_devices, shard_batch
from sdfa_tpu_torch.train import Experiment
from sdfa_tpu_torch.train.trainer import SCALER_NAMES

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

RTOL, ATOL = 1e-5, 1e-9  # metrics
STATE_TOL = 1e-5         # state_dict entries and scaler states, max abs
SEED = 5
STEPS = 2
TRAIN_MODEL_STEPS = 3
CPU = torch.device("cpu")


def _model_args(lstm_dropout):
    enc, trunk, head_s, head_r = _specs(lstm_dropout)
    return ((enc, trunk, head_s, head_r, 6 * N_TRIS, 3 * N_TRIS, KS, KR),
            dict(weight_norm=True, num_speakers=2))


@pytest.fixture(scope="module")
def start():
    """Perturbed initial weights (flax → state_dict), initialised as
    ``tests/test_torch_train_step.py`` does, and the global batches: 8 windows,
    4 adjacent-frame pairs each."""
    k = jax.random.PRNGKey(0)
    variables = jax.device_get(_jax_model().init(
        {"params": k, "dropout": k}, jnp.zeros((2, 8, 16, 3)), jnp.zeros((2,), jnp.int32),
        False))
    variables = _perturb(variables, np.random.default_rng(7))
    return dict(variables=variables, state_dict=state_dict_from_flax(variables),
                batches=[_batch(10 + step, coef=False) for step in range(STEPS)])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A generated dataset cut to 240 triangles, and the narrow network's overrides."""
    tmp = tmp_path_factory.mktemp("parallel_data")
    saved = synthetic.N_TRIS
    synthetic.N_TRIS = 240
    try:
        root = synthetic.generate(str(tmp / "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=2.0)
    finally:
        synthetic.N_TRIS = saved
    net = narrow_model()
    overrides = {
        "model": {"audio_encoder": net["audio_encoder"],
                  "output": dict(net["output"], output_dim_scale=6 * 240,
                                 output_dim_rotat=3 * 240)},
        "trainer": {"pca_targets": True, "multihost": True, "valid_gap_epochs": 1,
                    "anime_loader": {"batch_size": 2}}}
    return dict(root=root, overrides=overrides)


@pytest.fixture(scope="module")
def ranks(start, dataset, tmp_path_factory):
    """Two gloo ranks: STEPS train steps with dropout on and with dropout off,
    then ``api.train_model`` for TRAIN_MODEL_STEPS steps."""
    tmp = str(tmp_path_factory.mktemp("ranks"))

    def steps(lstm_dropout):
        args, kwargs = _model_args(lstm_dropout)
        return dict(kind="steps", hparams=_hparams(), model_args=args, model_kwargs=kwargs,
                    state_dict=start["state_dict"], batches=start["batches"], seed=SEED,
                    device="cpu", log_dir=os.path.join(tmp, f"steps_{lstm_dropout}"))

    job = {"dropout_on": steps(0.3), "dropout_off": steps(0.0),
           "train_model": dict(kind="train_model", config="dgrad", dataset_root=dataset["root"],
                               overrides=dataset["overrides"], max_steps=TRAIN_MODEL_STEPS,
                               device="cpu", log_dir=os.path.join(tmp, "train_model"))}
    return run_ranks(job, 2, os.path.join(tmp, "run")), tmp


# --- the helpers, against the JAX package's ---------------------------------------

def test_initialize_is_noop_single_process():
    assert multihost.maybe_initialize_distributed() is False
    assert multihost.maybe_initialize_distributed() is False  # idempotent
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)


def test_local_batch_size():
    assert multihost.local_batch_size(104) == 104  # one process: global == local


def test_pad_batch_to_devices_matches_jax():
    rng = np.random.default_rng(0)
    for n, devices in ((13, 8), (16, 8), (5, 2)):
        batch = {"x": rng.normal(size=(n, 2)).astype(np.float32),
                 "y": [np.arange(n), rng.normal(size=(n, 3, 1))]}
        got, got_n = pad_batch_to_devices(batch, devices)
        want, want_n = jmesh.pad_batch_to_devices(batch, devices)
        assert got_n == want_n == n
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_shard_batch_keeps_pairs():
    """Rank r holds rows [r·b, (r+1)·b) of each half: put back in order the
    shards are the global batch, and each shard's halves are pairs."""
    world, pairs = 2, 4
    frame = np.arange(pairs)
    batch = {"frame": np.concatenate([frame, frame + 100]),  # pair p: (p, p + 100)
             "feat": np.random.default_rng(0).normal(size=(2 * pairs, 3))}
    shards = [shard_batch(Mesh(world, r, CPU), batch) for r in range(world)]
    for key in batch:
        halves = [np.split(s[key], 2) for s in shards]
        again = np.concatenate([h[0] for h in halves] + [h[1] for h in halves])
        np.testing.assert_array_equal(again, batch[key])
    for s in shards:
        first, second = np.split(s["frame"], 2)
        np.testing.assert_array_equal(second, first + 100)
    tensors = shard_batch(Mesh(world, 1, CPU), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(tensors["frame"].numpy(), shards[1]["frame"])
    with pytest.raises(ValueError):
        mesh.shard_rows(np.zeros(6), 2, 0)  # 3 pairs do not split over 2 ranks


def test_motion_loss_needs_pair_keeping_shards():
    """The mean of the ranks' motion losses is the global one on pair-keeping
    shards; a contiguous split of the doubled batch gives another value."""
    rng = np.random.default_rng(1)
    pred = torch.from_numpy(rng.normal(size=(8, 1, 10, 6)).astype(np.float32))
    true = torch.from_numpy(rng.normal(size=(8, 1, 10, 6)).astype(np.float32))
    w = torch.ones(8)
    kw = dict(is_dgrad=True, is_face_data=True)
    full = float(L.mloss(pred, true, w, **kw))
    kept = np.mean([float(L.mloss(mesh.shard_rows(pred, 2, r), mesh.shard_rows(true, 2, r),
                                  mesh.shard_rows(w, 2, r), **kw)) for r in range(2)])
    split = np.mean([float(L.mloss(pred[4 * r:4 * r + 4], true[4 * r:4 * r + 4], w[:4], **kw))
                     for r in range(2)])
    assert kept == pytest.approx(full, rel=1e-6)
    assert abs(split - full) > 1e-2 * abs(full)


def test_draws_are_the_global_batch_rows():
    """Dropout and multiplicative noise under a mesh of 2: each rank's output
    is its rows of one process's output on the global batch, drawn from a
    generator seeded alike (the noise to the last bits of ``pow``); the noise
    keeps each pair's draw tied."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 5, 3)).astype(np.float32))

    def gen():
        return torch.Generator().manual_seed(11)

    want = dropout(x, 0.3, gen())
    noise = MultiplicativeNoise()
    noise.dropout_generator = gen()
    want_noise = noise(x)
    for r in range(2):
        m = Mesh(2, r, CPU)
        local = mesh.shard_rows(x, 2, r)
        assert torch.equal(dropout(local, 0.3, gen(), m), mesh.shard_rows(want, 2, r))
        noise.dropout_generator, noise.data_mesh = gen(), m
        got = noise(local)
        # the draws are equal; pow's vector and scalar paths may round apart
        torch.testing.assert_close(got, mesh.shard_rows(want_noise, 2, r), rtol=1e-6, atol=0)
        ratio = got / local
        assert torch.allclose(ratio[:2], ratio[2:])  # each pair, one draw
        noise.data_mesh = None


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("env", [
    {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "closed"},
    {"RANK": "0", "WORLD_SIZE": "2"},  # MASTER_ADDR / MASTER_PORT missing
], ids=["no-store", "partial-env"])
def test_launcher_env_without_group_raises(monkeypatch, env):
    """A launcher environment whose group cannot be joined raises: a rank that
    stayed local would train alone on its share of the batch."""
    for key in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, str(_closed_port()) if val == "closed" else val)
    with pytest.raises((RuntimeError, ValueError)):
        multihost.maybe_initialize_distributed(backend="gloo",
                                               timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()


def test_multihost_flag_in_one_process(tmp_path, start):
    """``trainer.multihost=true`` without a launcher: a mesh of one and a step."""
    hp = _hparams(trainer=dict(multihost=True))
    args, kwargs = _model_args(0.0)
    exp = Experiment(TConfig(hp), TModel(*args, **kwargs), str(tmp_path), "cpu", seed=SEED)
    assert exp.multihost is True and exp.n_devices == 1 and exp.is_chief
    metrics = exp.train_step(start["batches"][0])
    assert np.isfinite(float(metrics["total"])) and exp.step == 1


def test_sharded_reader_rows_match_one_rank(dataset):
    """Each rank's reader reads only its pairs of every global batch, and its
    rows are bit-equal to the matching rows of the one-rank batch."""
    hp = configure("dgrad", overrides=dataset["overrides"], dataset_root=dataset["root"])
    for method in ("raw_batches", "batches"):
        def first(shard):
            it = getattr(DatasetSlidingWindow(hp, training=True), method)(4, shard=shard)
            return [next(it) for _ in range(2)]

        whole = first((0, 1))
        for r in range(2):
            for got, want in zip(first((r, 2)), whole):
                assert sorted(got) == sorted(want)
                for key in want:
                    np.testing.assert_array_equal(got[key], mesh.shard_rows(want[key], 2, r),
                                                  err_msg=f"{method} {key} rank {r}")
    with pytest.raises(ValueError):
        next(DatasetSlidingWindow(hp, training=True).raw_batches(3, shard=(0, 2)))


# --- two ranks --------------------------------------------------------------------

def _ranks_equal(res):
    """The two ranks' metrics, state and scalers, bit for bit."""
    a, b = res
    assert a["metrics"] == b["metrics"]
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for key, val in a["state_dict"].items():
        assert torch.equal(val, b["state_dict"][key]), key
    assert a["scalers"] == b["scalers"]
    assert a["n_devices"] == b["n_devices"] == 2


def _close(got, want_metrics, want_sd, want_scalers):
    for step, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        assert sorted(g) == sorted(w)
        for key, val in w.items():
            assert g[key] == pytest.approx(val, rel=RTOL, abs=ATOL), (step, key)
    assert sorted(got["state_dict"]) == sorted(want_sd)
    worst = max((float((got["state_dict"][k] - want_sd[k]).abs().max()), k) for k in want_sd)
    assert worst[0] < STATE_TOL, worst
    for name in SCALER_NAMES:
        for g, w in zip(got["scalers"][name], want_scalers[name]):
            assert g == pytest.approx(w, abs=STATE_TOL), name


def test_two_ranks_match_one_rank_with_dropout(ranks, start, tmp_path):
    res = [r["dropout_on"] for r in ranks[0]]
    _ranks_equal(res)
    args, kwargs = _model_args(0.3)
    exp = Experiment(TConfig(_hparams()), TModel(*args, **kwargs), str(tmp_path), "cpu",
                     seed=SEED)
    exp.model.load_state_dict(start["state_dict"])
    want = [{k: float(v) for k, v in exp.train_step(b).items()} for b in start["batches"]]
    _close(res[0], want, exp.model.state_dict(),
           {n: [float(x) for x in s] for n, s in exp.scalers.items()})


def test_two_ranks_match_jax_sharded_step(ranks, start):
    """Dropout off: the JAX step on the global batch sharded over 8 devices."""
    res = [r["dropout_off"] for r in ranks[0]]
    _ranks_equal(res)
    jhp = JConfig(_hparams())
    tx, lr_fn, beta1_fn, _, _ = jtrainer.make_optimizer(jhp)
    variables = start["variables"]
    state = jtrainer.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        constants=variables["constants"], opt_state=tx.init(variables["params"]),
        scalers={n: JL.ScalerState.init() for n in SCALER_NAMES},
        step=jnp.zeros((), jnp.int32))
    step_fn = jtrainer.make_train_step(_jax_model(), jhp, tx, donate=False)
    jmesh8 = jmesh.make_mesh(jax.devices()[:8])
    state = jmesh.replicate(jmesh8, state)
    want = []
    for step, batch in enumerate(start["batches"]):
        state, m = step_fn(state, jmesh.shard_batch(jmesh8, batch), jax.random.PRNGKey(step),
                           jnp.asarray(float(lr_fn(jnp.asarray(step + 1)))), jnp.asarray(0.9))
        want.append({k: float(v) for k, v in m.items()})
    want_sd = state_dict_from_flax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats, "constants": state.constants}))
    _close(res[0], want, want_sd, {n: [float(x) for x in state.scalers[n]] for n in SCALER_NAMES})


def test_two_rank_train_model(ranks):
    """Rank 0 alone writes the run directory; its checkpoint loads in one
    process and holds rank 1's parameters; both ranks took the same steps."""
    res, tmp = ranks
    r0, r1 = (r["train_model"] for r in res)
    assert r0["steps"] == r1["steps"] == TRAIN_MODEL_STEPS
    assert r0["n_devices"] == r1["n_devices"] == 2
    assert r1["files"] == []
    for name in ("hparams.json", "params_info.txt", "last.ckpt", "best-ploss.ckpt",
                 "train_log/metrics.jsonl", "train_log/loss/epoch-loss.csv"):
        assert name in r0["files"], (name, r0["files"])
    task = api.load_task(os.path.join(tmp, "train_model", "rank0", "last.ckpt"), device="cpu")
    loaded = task.model.state_dict()
    assert sorted(loaded) == sorted(r1["state_dict"])
    for key, val in r1["state_dict"].items():
        assert torch.equal(loaded[key], val), key
