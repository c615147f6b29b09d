"""Weight bridge to and from the JAX package's flax variables, and a seeded
init.

The port's module and parameter names follow the flax tree, so a flax
path ``params/audio_encoder/built_layers_6/lstm/w_ih_l0`` is the state_dict
key ``audio_encoder.built_layers_6.lstm.w_ih_l0`` with the same shape and
layout: the bridge is a walk over the collections. It takes the nested
tree after ``jax.device_get`` (dicts of numpy arrays) and imports no jax.
``flax_variables_from_model`` goes the other way, to the same nested trees
as numpy, so parameters after N training steps can be compared.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats", "constants")


def _walk(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _walk(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def state_dict_from_flax(variables: dict) -> Dict[str, torch.Tensor]:
    """Nested flax variables (numpy leaves) → the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for col in COLLECTIONS:
        for path, arr in _walk(variables.get(col, {})):
            out[".".join(path)] = torch.from_numpy(np.array(arr, np.float32))
    return out


def load_flax_variables(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load every parameter, batch statistic and constant of ``variables``
    into ``model``; both sides must hold exactly the same names and shapes."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def flax_variables_from_model(model: torch.nn.Module) -> dict:
    """The model's state as nested flax collections of numpy arrays:
    parameters → ``params`` (trainable PCA bases and a learned speaker table
    among them, as flax keeps them), BatchNorm running statistics →
    ``batch_stats``, every other buffer (the frozen PCA bases) → ``constants``."""
    from ..nn.layers import BatchNorm

    out: Dict[str, dict] = {col: {} for col in COLLECTIONS}
    stat_owners = {name for name, mod in model.named_modules() if isinstance(mod, BatchNorm)}
    params = {name for name, _ in model.named_parameters()}
    for key, val in model.state_dict().items():
        if key in params:
            col = "params"
        else:
            col = "batch_stats" if key.rpartition(".")[0] in stat_owners else "constants"
        node = out[col]
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val.detach().cpu().numpy().copy()
    return out


def init_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded init of every learned parameter (no jax needed): each module
    that owns parameters resets them from one CPU generator, in module
    order, with the JAX package's init rules (kaiming/glorot kernels,
    weight-norm g = ‖v‖, LSTM uniform ±1/√H, zero biases, identity BN, a
    learned speaker table normal with variance 1/features). PCA bases,
    trainable or not, keep what they were loaded with."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None and any(True for _ in module.parameters(recurse=False)):
            reset(gen)
    return model
