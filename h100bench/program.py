"""The system under test, built from the benchmark's own configuration file and
seeded weights: the one place that reaches into ``sdfa_tpu_torch``."""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from . import frozen, weights

TEMPLATE_SEED = 0


def hparams(cfg: Dict):
    from sdfa_tpu_torch.config import ConfigDict

    return ConfigDict(copy.deepcopy(cfg["hparams"]))


def install_template():
    """The frozen torus template, installed as the program's mesh; returns it."""
    from sdfa_tpu_torch.viewer import frame

    tmpl = frozen.synthetic_template(TEMPLATE_SEED)
    frame.set_template_mesh(*tmpl)
    return tmpl


def state_shapes(hp) -> Dict[str, torch.Size]:
    from sdfa_tpu_torch.models import build_model

    with torch.device("meta"):
        return {k: v.shape for k, v in build_model(hp, load_pca=False).state_dict().items()}


def model_and_state(hp, seed: int, device, pca: Dict[str, np.ndarray] = None):
    """(the program's model on ``device`` holding the seeded weights, the
    seeded state dict itself). ``pca``: the PCA bases by state name, where
    they come from a corpus and not from the seed."""
    from sdfa_tpu_torch.models import build_model

    shapes = state_shapes(hp)
    state = weights.seeded_state({k: s for k, s in shapes.items() if k not in (pca or {})},
                                 seed, device)
    for k, v in (pca or {}).items():
        state[k] = torch.as_tensor(v, device=device)
    model = build_model(hp, load_pca=False).to(device)
    model.load_state_dict(state)
    return model, state


def task(hp, model, device):
    from sdfa_tpu_torch.task import AnimationTask

    return AnimationTask(hp, model, device, device_frontend=True, overlap_frontend=True)
