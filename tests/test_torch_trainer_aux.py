"""``Trainer(aux_loaders=)``, port vs the JAX ``Trainer``: two aux loaders
(three batches and one) each add an optimization step after every main step,
cycling across epochs, counted in the global step and left out of the epoch's
metrics. Two epochs of two main batches from identical weights at narrow
widths (BatchNorm on batch statistics, dropout 0), then the loss history row
by row, the step count and the parameters. The aux step's dropout seed is a
stream of its main step's.

Tolerances: the history's means 1e-5 relative, the parameters after 12
steps 1e-5 — f32 on both sides, sums in another order.
"""

import numpy as np
import pytest
import torch

import jax

from test_torch_nn import _perturb
from test_torch_train_step import _batch, _hparams, _jax_model, _torch_model

from sdfa_tpu.train import trainer as jtrainer
from sdfa_tpu.utils.config import ConfigDict as JConfig
from sdfa_tpu_torch.compat import load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.config import ConfigDict as TConfig
from sdfa_tpu_torch.train import Experiment, Trainer
from sdfa_tpu_torch.train.trainer import step_seed

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _loaders():
    main = [_batch(50 + i, coef=True) for i in range(2)]
    aux = {"speech": [_batch(60 + i, coef=True) for i in range(3)],
           "extra": [_batch(70, coef=False)]}
    return main, aux


def test_aux_loader_history_matches_jax(tmp_path):
    hp = _hparams(trainer=dict(max_epochs=2, save_gap_epochs=None))
    jexp = jtrainer.Experiment(JConfig(hp), _jax_model(), str(tmp_path / "jax"))
    variables = _perturb(jax.device_get({"params": jexp.state.params,
                                         "batch_stats": jexp.state.batch_stats,
                                         "constants": jexp.state.constants}),
                         np.random.default_rng(3))
    jexp.state = jexp.state.replace(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=jexp.tx.init(variables["params"]))
    main, aux = _loaders()
    jtr = jtrainer.Trainer(jexp, main, aux_loaders=aux)
    jtr.train()

    exp = Experiment(TConfig(hp), _torch_model(), str(tmp_path / "torch"), "cpu")
    load_flax_variables(exp.model, variables)
    main, aux = _loaders()
    trainer = Trainer(exp, main, aux_loaders=aux)
    trainer.train()

    assert exp.step == int(jax.device_get(jexp.state.step)) == 2 * 2 * 3
    assert trainer.aux_steps == 2 * 2 * 2
    assert exp.epoch == jexp.epoch == 2
    assert len(trainer._history) == len(jtr._history) == 2
    for got, want in zip(trainer._history, jtr._history):
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            assert got[key] == pytest.approx(val, rel=1e-5, abs=1e-9), key
    want_sd = state_dict_from_flax(jax.device_get({"params": jexp.state.params,
                                                   "batch_stats": jexp.state.batch_stats,
                                                   "constants": jexp.state.constants}))
    got_sd = exp.model.state_dict()
    worst = max((float((got_sd[k] - want_sd[k]).abs().max()), k) for k in want_sd)
    assert worst[0] < 1e-5, worst


def test_aux_loader_cycles_and_seeds_its_own_stream(tmp_path):
    """An empty aux loader adds no step; a loader of one batch adds one per
    main step; the aux step's dropout seed is (seed, main step, 1_000_003 +
    index), apart from every main step's."""
    exp = Experiment(TConfig(_hparams()), _torch_model(), str(tmp_path), "cpu", seed=9)
    seeds = []
    real = exp.train_step

    def spy(batch, dropout_seed=None):
        seeds.append(dropout_seed)
        return real(batch, dropout_seed=dropout_seed)

    exp.train_step = spy
    main, aux = _loaders()
    trainer = Trainer(exp, main, aux_loaders={"none": [], "one": aux["extra"]})
    trainer.train()
    assert exp.step == 4 and trainer.aux_steps == 2
    assert seeds == [None, step_seed(9, 0, 1_000_004), None, step_seed(9, 2, 1_000_004)]
    assert len({step_seed(9, s) for s in range(4)} | {seeds[1], seeds[3]}) == 6
    assert torch.isfinite(torch.stack([p.detach().sum() for p in exp.model.parameters()])).all()
