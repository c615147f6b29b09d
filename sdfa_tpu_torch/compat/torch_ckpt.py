"""Reference PyTorch checkpoints into the port (counterpart of
``sdfa_tpu/compat/torch_ckpt.py``, copied).

A user of the reference framework loads a trained ``epochXXXX-stepXXXXXX.ckpt``
(a ``torch.save`` payload, saber/trainer/manager/checkpoints.py:50-64:
{epoch, global_step, state, optim_*}) into the flax-tree names that the
port's parameters carry (``compat/from_flax.py``):

- the legacy module renames first (the published checkpoints use old module
  names; reference speech_anime/api.py:170-197, which also drops the stray
  ``hamm`` buffer);
- weight-norm (g, v) pairs to (kernel_g, kernel_v) with the axis-order
  transposes (torch Linear (out, in) → (in, out); LSTM weight_ih (4H, in) →
  (in, 4H));
- BatchNorm weight / bias / running statistics → scale / bias + batch_stats;
- the PCA compT / means buffers → the "constants" collection.

``convert_state_dict``'s trees go into a model through
``from_flax.load_flax_variables``. The file is read with
``weights_only=True``: tensors, numbers, strings and containers only.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Tuple

import numpy as np

log = logging.getLogger(__name__)

_LEGACY_RENAMES = (
    ("_ext_batch_norm", "_ext_post_bn"),
    ("audio_encoder.layers.0", "_model._audio_encoder._layers.1"),
    ("audio_encoder.layers.1", "_model._audio_encoder._layers.2"),
    ("audio_encoder.layers.2", "_model._audio_encoder._layers.3"),
    ("audio_encoder.layers.3", "_model._audio_encoder._layers.4"),
    ("audio_encoder.layers.4", "_model._audio_encoder._layers.5"),
    ("audio_encoder.layers.5", "_model._audio_encoder._layers.6"),
    ("time_aggregator.layers.0", "_model._audio_encoder._layers.9"),
    ("time_aggregator.layers.1", "_model._audio_encoder._layers.10"),
    ("anime_decoder.layers.", "_model._output_module._layers."),
    ("anime_decoder.layers_scale", "_model._output_module._scale_layers"),
    ("anime_decoder.layers_rotat", "_model._output_module._rotat_layers"),
    ("anime_decoder.proj_scale", "_model._output_module._scale_pca"),
    ("anime_decoder.proj_rotat", "_model._output_module._rotat_pca"),
)

# reference stack index → our LayerStack child index (identical ordering)
_STACK_MAP = {
    "_model._audio_encoder._layers": "audio_encoder",
    "_model._output_module._layers": "output_trunk",
    "_model._output_module._scale_layers": "scale_head",
    "_model._output_module._rotat_layers": "rotat_head",
}


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A reference checkpoint file → (flat numpy state dict with the legacy
    renames applied, {"epoch", "global_step"} where present)."""
    import torch

    return reference_state(torch.load(path, map_location="cpu", weights_only=True))


def reference_state(ckpt: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``load_torch_checkpoint`` on a payload already read."""
    state = ckpt.get("state", ckpt)
    out = {}
    for key, val in state.items():
        nk = key
        for old, new in _LEGACY_RENAMES:
            nk = nk.replace(old, new)
        if nk == "hamm":  # stray buffer in old checkpoints (api.py:195)
            continue
        out[nk] = val.detach().cpu().numpy() if hasattr(val, "detach") else np.asarray(val)
    meta = {k: ckpt[k] for k in ("epoch", "global_step") if k in ckpt}
    return out, meta


def convert_state_dict(state: Dict[str, np.ndarray]) -> Tuple[dict, dict, dict]:
    """Flat torch state dict → (params, batch_stats, constants) nested trees.

    Handles the shipped dgrad/offsets architectures (conv2d/pool/freq-lstm/
    lstm/bahdanau attention stacks + fc heads + PCA buffers).
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    constants: Dict[str, Any] = {}

    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value, np.float32)

    for key, val in state.items():
        parts = key.split(".")
        # --- PCA buffers -------------------------------------------------
        if ("._scale_pca." in key or "._rotat_pca." in key or key.endswith("._pca.compT")
                or key.endswith("._pca.means")):
            which = ("scale_pca" if "_scale_pca" in key else
                     "rotat_pca" if "_rotat_pca" in key else "pca")
            put(constants, (which, parts[-1]), val)
            continue
        # --- speaker embedding -------------------------------------------
        if "_speaker_embedding" in key and "weight" in parts[-1]:
            put(params, ("speaker_embedding", "Embed_0", "embedding"), val)
            continue
        # --- layer stacks --------------------------------------------------
        m = re.match(r"_model\.(_audio_encoder\._layers|_output_module\._layers"
                     r"|_output_module\._scale_layers|_output_module\._rotat_layers)"
                     r"\.(\d+)\.(.*)$", key)
        if not m:
            log.warning("torch ckpt key not mapped: %s", key)
            continue
        stack_ref = "_model." + m.group(1)
        stack = _STACK_MAP[stack_ref]
        # our encoder stack includes the non-parametric permute at index 0 and
        # pools, same indices as the reference _layers list → direct mapping
        child = f"built_layers_{int(m.group(2))}"
        rest = m.group(3)
        _map_layer_param(params, stats, (stack, child), rest, val)

    return params, stats, constants


def _map_layer_param(params, stats, prefix, rest, val):
    def put(tree, path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(value, np.float32)

    # batch norm
    if "_ext_post_bn" in rest or "_ext_prev_bn" in rest:
        bn = "post_bn" if "post" in rest else "prev_bn"
        leaf = rest.split(".")[-1]
        if leaf == "weight":
            put(params, prefix + (bn, "scale"), val)
        elif leaf == "bias":
            put(params, prefix + (bn, "bias"), val)
        elif leaf == "running_mean":
            put(stats, prefix + (bn, "mean"), val)
        elif leaf == "running_var":
            put(stats, prefix + (bn, "var"), val)
        return
    # freq-lstm internals
    if rest.startswith("_lstm."):
        _map_rnn(params, prefix + ("lstm",), rest[len("_lstm."):], val, put)
        return
    if rest.startswith("_proj."):
        _map_linear(params, prefix + ("proj",), rest[len("_proj."):], val, put)
        return
    # attention internals
    if rest.startswith("_conv_query."):
        _map_conv(params, prefix + ("conv_query",), rest[len("_conv_query."):], val, put)
        return
    for sub in ("proj_key", "proj_qry", "v"):
        if rest.startswith(sub + "."):
            _map_linear(params, prefix + (sub,), rest[len(sub) + 1:], val, put)
            return
    if rest == "b":
        put(params, prefix + ("b",), val)
        return
    # plain RNN layer (torch LSTM/GRU directly in the stack)
    if re.match(r"(weight|bias)_(ih|hh)_l\d+(_reverse)?$", rest):
        _map_rnn(params, prefix, rest, val, put)
        return
    # conv / fc with optional weight norm
    if val.ndim >= 3 or (val.ndim == 1 and rest.startswith("weight_g")):
        _map_conv(params, prefix, rest, val, put)
    else:
        _map_linear(params, prefix, rest, val, put)


def _map_linear(params, prefix, rest, val, put):
    # torch Linear weight (out, in) → ours (in, out)
    if rest == "weight":
        put(params, prefix + ("kernel",), val.T)
    elif rest == "weight_v":
        put(params, prefix + ("kernel_v",), val.T)
    elif rest == "weight_g":
        put(params, prefix + ("kernel_g",), val.reshape(-1))
    elif rest == "bias":
        put(params, prefix + ("bias",), val)


def _map_conv(params, prefix, rest, val, put):
    # torch conv weight (O, I, k...) — ours uses the same OIHW layout
    if rest == "weight":
        put(params, prefix + ("kernel",), val)
    elif rest == "weight_v":
        put(params, prefix + ("kernel_v",), val)
    elif rest == "weight_g":
        put(params, prefix + ("kernel_g",), val.reshape(-1))
    elif rest == "bias":
        put(params, prefix + ("bias",), val)


def _map_rnn(params, prefix, rest, val, put):
    m = re.match(r"(weight|bias)_(ih|hh)_(l\d+(?:_reverse)?)$", rest)
    if not m:
        return
    kind, gate, layer = m.groups()
    name = f"{'w' if kind == 'weight' else 'b'}_{gate}_{layer}"
    put(params, prefix + (name,), val.T if kind == "weight" else val)
