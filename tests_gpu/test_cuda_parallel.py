"""Two gloo ranks on ``cuda:0`` against one process on the card: two train steps
of a narrow dgrad-type network whose recurrences are 128 wide, so that they run
the training core (K5: FreqLstm's and the 2-layer time stack's, 3 forward and 3
backward launches a step), with dropout on and the shipped optimizer (Adam, lr
1e-4). The ranks (``tests/_torch_dist_worker.py``) are bit-equal to each other,
and within the tolerances of ``tests/test_torch_parallel.py`` of the one
process: every metric rel 1e-5 / abs 1e-9, every ``state_dict`` entry and the
scaler states 1e-5 max abs."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))
from _torch_dist_worker import run_ranks  # noqa: E402

from sdfa_tpu_torch.compat import init_params  # noqa: E402
from sdfa_tpu_torch.config import ConfigDict  # noqa: E402
from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation  # noqa: E402
from sdfa_tpu_torch.ops import bilstm_core  # noqa: E402
from sdfa_tpu_torch.train import Experiment  # noqa: E402

pytestmark = pytest.mark.gpu

BN = "batch_norm={'momentum': 0.01, 'eps': 0.001}"
LRELU = "act=lrelu@a:0.2"
N_TRIS, KS, KR = 10, 5, 4
MODEL_ARGS = (
    [("permute", (0, 3, 2, 1)),
     ("conv2d", 3, 4, (3, 1), (1, 1), LRELU, BN),
     ("pool2d", "max", (2, 1)),
     ("conv2d", 4, 6, (1, 1), (1, 1), LRELU, BN),
     ("freq-lstm", 6, 8, "hidden_size=128", "output_size=12"),
     ("squeeze", 2),
     ("permute", (0, 2, 1)),
     ("lstm", 12, 128, "num_layers=2", "bidirectional=True", "dropout=0.3"),
     ("attn", "bah", 256, 8, 2, "scale_score_at_eval=2.0")],
    [("fc", 256 + 2, 8, LRELU, "cat_condition=2")],
    [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"), ("fc", 8, KS, "act=linear")],
    [("fc", 8 + 2, 8, "act=tanh", "cat_condition=2"), ("fc", 8, KR, "act=linear")],
    6 * N_TRIS, 3 * N_TRIS, KS, KR)
MODEL_KWARGS = dict(weight_norm=True, num_speakers=2)
HPARAMS = dict(
    audio=dict(feature=dict(sliding_window_frames=8, with_delta=True), mel=dict(n_mels=16),
               sample_rate=8000),
    loss=dict(ploss_scale=1, mloss_scale=2, eloss_scale=1, dynamic_scalar=True,
              anime_loss_weight=None),
    optim=dict(name="Adam", args=dict(lr=1e-4, weight_decay=0), lr_scheduler=None),
    trainer=dict(max_epochs=1, save_gap_epochs=1, valid_gap_epochs=0, reference_metric="ploss",
                 reference_metric_larger=False),
    model=dict(face_data_type="dgrad_3d", prediction_type="face_data"))
SEED = 5


def _batch(seed, bsz=8):
    """First half frame i, second half frame i + 1."""
    rng = np.random.default_rng(seed)
    half = rng.integers(0, 2, (bsz // 2,)).astype(np.int32)
    return {"audio_feat": rng.normal(0.4, 0.3, (bsz, 8, 16, 3)).astype(np.float32),
            "speaker_id": np.concatenate([half, half]),
            "dgrad_3d_scale": rng.normal(0, 0.1, (bsz, 1, N_TRIS, 6)).astype(np.float32),
            "dgrad_3d_rotat": rng.normal(0, 0.1, (bsz, 1, N_TRIS, 3)).astype(np.float32)}


def test_two_ranks_on_one_card_match_one_process(cuda, tmp_path):
    model = init_params(SpeechDrivenAnimation(*MODEL_ARGS, **MODEL_KWARGS), 3)
    rng = np.random.default_rng(99)
    with torch.no_grad():
        for name in ("scale_pca", "rotat_pca"):
            pca = getattr(model, name)
            pca.compT.copy_(torch.from_numpy(rng.normal(0, 0.1, pca.compT.shape)))
            pca.means.copy_(torch.from_numpy(rng.normal(0, 0.01, pca.means.shape)))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_batch(10 + step) for step in range(2)]

    exp = Experiment(ConfigDict(HPARAMS), SpeechDrivenAnimation(*MODEL_ARGS, **MODEL_KWARGS),
                     str(tmp_path / "one"), "cuda:0", seed=SEED)
    exp.model.load_state_dict(state)
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    want = [{k: float(v) for k, v in exp.train_step(b).items()} for b in batches]
    assert (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES) == (6, 6)

    job = {"steps": dict(kind="steps", hparams=HPARAMS, model_args=MODEL_ARGS,
                         model_kwargs=MODEL_KWARGS, state_dict=state, batches=batches,
                         seed=SEED, device="cuda:0", log_dir=str(tmp_path / "ranks"))}
    r0, r1 = (r["steps"] for r in run_ranks(job, 2, str(tmp_path / "run")))
    assert r0["k5_launches"] == r1["k5_launches"] == (6, 6)
    assert r0["metrics"] == r1["metrics"] and r0["scalers"] == r1["scalers"]
    for key, val in r0["state_dict"].items():
        assert torch.equal(val, r1["state_dict"][key]), key
    for step, (got, ref) in enumerate(zip(r0["metrics"], want)):
        for key, val in ref.items():
            assert got[key] == pytest.approx(val, rel=1e-5, abs=1e-9), (step, key)
    ref_sd = {k: v.cpu() for k, v in exp.model.state_dict().items()}
    worst = max((float((r0["state_dict"][k] - ref_sd[k]).abs().max()), k) for k in ref_sd)
    assert worst[0] < 1e-5, worst
    for name, vals in r0["scalers"].items():
        for got, ref in zip(vals, exp.scalers[name]):
            assert got == pytest.approx(float(ref), abs=1e-5), name
