"""Layer-spec DSL and the sequential engine (counterpart of
``sdfa_tpu/nn/spec.py``): config tuples such as
``("conv2d", 3, 32, (3, 1), (1, 1), "act=lrelu@a:0.2", "batch_norm={...}")``
become modules named ``built_layers_{i}``, run in order with the
``cat_condition`` broadcast-concat, the attention query window and
``skip_connect`` residuals; ``start``/``stop`` run a sub-range (the
window-overlap path's per-frame prefix and per-window suffix).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import attention, layers, recurrent

_BREVS = {
    "act": "activation", "ksz": "kernel_size", "hop": "stride", "pad": "padding",
    "dil": "dilation", "in": "in_channels", "out": "out_channels",
    "init": "init_method", "nonlinear": "init_nonlinearity",
}
_ENGINE_KEYS = ("residual", "condition", "cat_condition", "skip_connect", "query_offset")

# name → (constructor, positional arg names, accepts weight_norm): every name
# of the JAX registry (sdfa_tpu/nn/spec.py:46-87)
_REGISTRY: Dict[str, Tuple[Any, List[str], bool]] = {
    "fc": (layers.FullyConnected, ["in_channels", "out_channels", "bias"], True),
    "fp": (layers.Conv1d, ["in_channels", "out_channels", "bias"], True),
    "conv1d": (layers.Conv1d, ["in_channels", "out_channels", "kernel_size", "stride",
                               "padding", "dilation", "groups", "bias"], True),
    "conv2d": (layers.Conv2d, ["in_channels", "out_channels", "kernel_size", "stride",
                               "padding", "dilation", "groups", "bias"], True),
    "deconv2d": (layers.ConvTranspose2d, ["in_channels", "out_channels", "kernel_size", "stride",
                                          "padding", "output_padding", "dilation", "groups",
                                          "bias", "want_size"], True),
    "deconv1d": (layers.ConvTranspose1d, ["in_channels", "out_channels", "kernel_size", "stride",
                                          "padding", "output_padding", "dilation", "groups",
                                          "bias", "want_size"], True),
    "pool1d": (layers.Pool1d, ["mode", "kernel_size", "stride", "padding"], False),
    "res1d": (layers.ResidualStack1d, ["in_channels", "out_channels", "num_blocks"], True),
    "pool2d": (layers.Pool2d, ["mode", "kernel_size", "stride", "padding"], False),
    "flatten": (layers.Flatten, ["start_dim"], False),
    "permute": (layers.Permute, ["dims"], False),
    "transpose": (layers.Transpose, ["dim0", "dim1"], False),
    "squeeze": (layers.Squeeze, ["dim"], False),
    "unsqueeze": (layers.Unsqueeze, ["dim"], False),
    "view": (layers.View, ["shape"], False),
    "identity": (layers.Identity, [], False),
    "gradx": (layers.GradScaler, ["scale"], False),
    "lstm": (recurrent.LSTM, ["input_size", "hidden_size", "num_layers", "bias",
                              "batch_first", "dropout", "bidirectional"], False),
    "gru": (recurrent.GRU, ["input_size", "hidden_size", "num_layers", "bias",
                            "batch_first", "dropout", "bidirectional"], False),
    "freq-lstm": (recurrent.FreqLstm, ["input_size", "freq_length", "hidden_size",
                                       "output_size", "bias", "mode"], False),
    "lstm2d": (recurrent.LSTM2d, ["input_size", "hidden_size", "num_layers", "bias"], False),
    "attn": (attention.create_self_atten, ["name", "memory_size", "num_units",
                                           "query_radius"], False),
    "mul-noise": (layers.MultiplicativeNoise, ["base", "mean", "std"], False),
}


def _coerce(val: str):
    """JSON-coerce a ``key=val`` value, tolerating python literals."""
    if val in ("True", "true"):
        return True
    if val in ("False", "false"):
        return False
    if val in ("None", "null"):
        return None
    try:
        return json.loads(val.replace("'", '"'))
    except ValueError:
        return val


class LayerParser:
    """One layer-info tuple → constructor kwargs + engine extras."""

    def __init__(self, layer_info: Sequence[Any]):
        layer_info = list(layer_info)
        self.name = layer_info[0]
        if self.name not in _REGISTRY:
            raise NotImplementedError(f"layer '{self.name}' is not supported")
        self.ctor, pos_names, takes_wn = _REGISTRY[self.name]
        self.kwargs: Dict[str, Any] = {}
        self.extras: Dict[str, Any] = {}
        pos = 0
        for item in layer_info[1:]:
            if isinstance(item, str) and "=" in item:
                key, _, val = item.partition("=")
                key, val = _BREVS.get(key, key), _coerce(val)
                if key in _ENGINE_KEYS:
                    self.extras[key] = val
                elif key != "weight_norm" or takes_wn:
                    self.kwargs[key] = val
            else:
                if pos >= len(pos_names):
                    raise ValueError(f"too many positional args for '{self.name}': {layer_info}")
                self.kwargs[pos_names[pos]] = item
                pos += 1

    @property
    def is_attention(self) -> bool:
        return self.name == "attn"

    def build(self) -> nn.Module:
        return self.ctor(**self.kwargs)


def parse_specs(layer_info_list, weight_norm: bool = False) -> List[LayerParser]:
    """Parse a config layer list, appending the model-global weight_norm."""
    return [LayerParser(list(info) + [f"weight_norm={bool(weight_norm)}"])
            for info in layer_info_list]


class LayerStack(nn.Module):
    """Sequential engine: ``(x, condition) → (out, align_dict)``."""

    def __init__(self, specs, weight_norm: bool = False, tag: str = "stack"):
        super().__init__()
        self.tag = tag
        self.parsers = parse_specs(specs, weight_norm)
        self.layers = []
        for i, parser in enumerate(self.parsers):
            module = parser.build()
            self.add_module(f"built_layers_{i}", module)  # the flax tree's names
            self.layers.append(module)

    def forward(self, x, condition: Optional[torch.Tensor] = None,
                start: int = 0, stop: Optional[int] = None):
        """Run layers [start:stop); skip_connect indices stay absolute."""
        history: List[Optional[torch.Tensor]] = [None] * start
        aligns = {}
        for i in range(start, len(self.layers) if stop is None else stop):
            module, parser = self.layers[i], self.parsers[i]
            history.append(x)
            inputs = x
            cat_dim = parser.extras.get("cat_condition")
            if condition is not None and cat_dim is not None:
                if cat_dim < 0:
                    cat_dim += inputs.ndim
                shape = [1] * inputs.ndim
                shape[0], shape[cat_dim] = condition.shape
                cond = condition.reshape(shape).expand(
                    [condition.shape[1] if a == cat_dim else s
                     for a, s in enumerate(inputs.shape)])
                inputs = torch.cat([inputs, cond], dim=cat_dim)
            if parser.is_attention:
                radius = parser.kwargs.get("query_radius", 1)
                mid = inputs.shape[1] // 2 + parser.extras.get("query_offset", 0)
                query = inputs[:, mid - (radius - 1):mid + radius, :]
                out, align = module(query, inputs)
                aligns[f"{self.tag}{i:02d}"] = align
            else:
                out = module(inputs)
            skip = parser.extras.get("skip_connect")
            if isinstance(skip, int):
                out = out + history[skip]
            x = out
        return x, aligns


def _as_pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def time_independent_prefix(parsers: Sequence[LayerParser]) -> Tuple[int, int]:
    """(prefix_len, time_axis): the leading layers provably independent
    across time (each timestep computable from that timestep alone), and
    where the time axis sits in their output; starts from (N, T, F, C)."""
    taxis, ndim = 1, 4
    for i, p in enumerate(parsers):
        if "cat_condition" in p.extras:
            return i, taxis
        skip = p.extras.get("skip_connect")
        if isinstance(skip, int) and not (0 <= skip < i):
            return i, taxis
        name = p.name
        if name == "permute":
            dims = p.kwargs.get("dims")
            if dims is None or len(dims) != ndim:
                return i, taxis
            taxis = list(dims).index(taxis)
        elif name in ("conv2d", "pool2d"):
            if ndim != 4 or taxis in (0, 1):
                return i, taxis
            k = _as_pair(p.kwargs.get("kernel_size", 1))
            s = _as_pair(p.kwargs.get("stride", k if name == "pool2d" else 1))
            d = _as_pair(p.kwargs.get("dilation", 1))
            j = taxis - 2
            if k[j] != 1 or s[j] != 1 or (name == "conv2d" and d[j] != 1):
                return i, taxis
        elif name in ("conv1d", "fp"):
            if ndim != 3 or taxis != 2:
                return i, taxis
            if p.kwargs.get("kernel_size", 1) != 1 or p.kwargs.get("stride", 1) != 1:
                return i, taxis
        elif name == "freq-lstm":
            if ndim != 4 or taxis != 3:
                return i, taxis
        elif name == "fc":
            if taxis == ndim - 1:
                return i, taxis
        elif name == "squeeze":
            dim = p.kwargs.get("dim")
            if dim is None:
                return i, taxis
            if dim < 0:
                dim += ndim
            if dim == taxis:
                return i, taxis
            if dim < taxis:
                taxis -= 1
            ndim -= 1
        elif name == "unsqueeze":
            dim = p.kwargs.get("dim")
            if dim is None:
                return i, taxis
            if dim < 0:
                dim += ndim + 1
            if dim <= taxis:
                taxis += 1
            ndim += 1
        elif name == "transpose":
            d0, d1 = p.kwargs.get("dim0"), p.kwargs.get("dim1")
            if d0 is None or d1 is None:
                return i, taxis
            d0, d1 = d0 + ndim if d0 < 0 else d0, d1 + ndim if d1 < 0 else d1
            if taxis == d0:
                taxis = d1
            elif taxis == d1:
                taxis = d0
        elif name in ("identity", "gradx", "mul-noise"):
            pass  # elementwise
        else:
            # lstm / gru / lstm2d / attn (temporal), flatten / view / res1d /
            # deconv* / pool1d (unanalysed): a conservative stop
            return i, taxis
    return len(parsers), taxis


def _suffix_skips_into_prefix(parsers, split: int) -> bool:
    """True if a suffix layer's skip_connect resolves before ``split``."""
    for i in range(split, len(parsers)):
        skip = parsers[i].extras.get("skip_connect")
        if isinstance(skip, int) and (i + 1 + skip if skip < 0 else skip) < split:
            return True
    return False


def encoder_overlap_split(encoder_specs, weight_norm: bool) -> Tuple[int, int]:
    """(prefix_len, time_axis) of the encoder's time-independent prefix;
    (0, 1) when a suffix layer reads prefix history."""
    parsers = parse_specs(encoder_specs, weight_norm)
    split, taxis = time_independent_prefix(parsers)
    if _suffix_skips_into_prefix(parsers, split):
        return 0, 1
    return split, taxis
