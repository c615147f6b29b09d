"""Torch-checkpoint ingestion: torch modules → our params, forward parity."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.compat.torch_ckpt import (
    _LEGACY_RENAMES,
    _map_layer_param,
    convert_state_dict,
)
from sdfa_tpu.nn import layers as L
from sdfa_tpu.nn import recurrent as R

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


def _roundtrip(prefix, torch_module, rename=lambda k: k):
    params, stats = {}, {}
    for key, val in torch_module.state_dict().items():
        _map_layer_param(params, stats, prefix, rename(key), val.numpy())
    return params, stats


class TestLayerMapping:
    def test_weight_norm_linear(self):
        tl = torch.nn.utils.weight_norm(torch.nn.Linear(6, 4))
        params, _ = _roundtrip(("stack", "built_layers_0"), tl)
        leaf = params["stack"]["built_layers_0"]
        assert leaf["kernel_v"].shape == (6, 4)
        assert leaf["kernel_g"].shape == (4,)

        ours = L.FullyConnected(in_channels=6, out_channels=4, weight_norm=True)
        x = np.random.default_rng(0).normal(size=(3, 6)).astype(np.float32)
        out = ours.apply({"params": leaf}, jnp.asarray(x))
        ref = tl(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)

    def test_weight_norm_conv2d_with_bn(self):
        conv = torch.nn.utils.weight_norm(torch.nn.Conv2d(3, 8, (3, 1), padding=(1, 0)))
        bn = torch.nn.BatchNorm2d(8, momentum=0.01, eps=1e-3)
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.data.normal_()
        bn.bias.data.normal_()
        params, stats = {}, {}
        for key, val in conv.state_dict().items():
            _map_layer_param(params, stats, ("s", "built_layers_1"), key, val.detach().numpy())
        for key, val in bn.state_dict().items():
            if "num_batches" in key:
                continue
            _map_layer_param(params, stats, ("s", "built_layers_1"),
                             "_ext_post_bn." + key, val.detach().numpy())

        ours = L.Conv2d(in_channels=3, out_channels=8, kernel_size=(3, 1),
                        weight_norm=True, batch_norm=dict(momentum=0.01, eps=1e-3))
        x = np.random.default_rng(1).normal(size=(2, 3, 16, 5)).astype(np.float32)
        out = ours.apply(
            {"params": params["s"]["built_layers_1"],
             "batch_stats": stats["s"]["built_layers_1"]},
            jnp.asarray(x), training=False,
        )
        conv.eval(); bn.eval()
        ref = bn(conv(torch.from_numpy(x))).detach().numpy()
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)

    def test_lstm_mapping(self):
        tl = torch.nn.LSTM(6, 5, num_layers=1, bias=True, batch_first=True,
                           bidirectional=True)
        params, _ = _roundtrip(("s", "built_layers_0"), tl)
        leaf = params["s"]["built_layers_0"]
        assert leaf["w_ih_l0"].shape == (6, 20)
        assert leaf["w_ih_l0_reverse"].shape == (6, 20)
        ours = R.LSTM(input_size=6, hidden_size=5, num_layers=1, bias=True,
                      bidirectional=True)
        x = np.random.default_rng(2).normal(size=(2, 7, 6)).astype(np.float32)
        out = ours.apply({"params": leaf}, jnp.asarray(x))
        ref, _ = tl(torch.from_numpy(x))
        np.testing.assert_allclose(np.asarray(out), ref.detach().numpy(), atol=2e-5)


class TestFullStateDict:
    def test_convert_with_legacy_names(self):
        # legacy "anime_decoder.layers_scale" style names must remap
        fc = torch.nn.utils.weight_norm(torch.nn.Linear(4, 3))
        state = {}
        for key, val in fc.state_dict().items():
            state[f"_model._output_module._scale_layers.0.{key}"] = val.numpy()
        state["_model._output_module._scale_pca.compT"] = np.zeros((12, 3), np.float32)
        state["_model._output_module._scale_pca.means"] = np.zeros((12,), np.float32)
        params, stats, constants = convert_state_dict(state)
        assert "scale_head" in params
        assert "kernel_v" in params["scale_head"]["built_layers_0"]
        assert constants["scale_pca"]["compT"].shape == (12, 3)

    def test_legacy_rename_table_matches_reference(self):
        # spot-check the documented api.py:170-197 mapping
        renames = dict(_LEGACY_RENAMES)
        assert renames["anime_decoder.proj_scale"] == "_model._output_module._scale_pca"
        assert renames["audio_encoder.layers.0"] == "_model._audio_encoder._layers.1"
