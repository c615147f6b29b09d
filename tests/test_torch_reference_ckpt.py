"""Reference-framework checkpoints into the port (``compat/torch_ckpt.py`` and
``api.load_task``), against the JAX package on the same file.

``reference_checkpoint`` writes the reference's schema ({epoch, global_step,
state}, saber/trainer/manager/checkpoints.py:50-64) from flax variables: the
reference's flat ``_model.``-prefixed module names and torch layouts, and in a
second case the legacy names of the published checkpoints with their stray
``hamm`` buffer. The JAX ``convert_state_dict`` must give the variables back
exactly, which holds the helper itself; then the JAX ``api.load_task`` and the
port's ``load_task`` read the same file and answer the same request within
1e-5 m. The dgrad network at narrow widths over a small synthetic template
(``test_torch_slice.py::task_pair``), on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from test_torch_slice import _signal, task_pair

from sdfa_tpu import api as japi
from sdfa_tpu.compat.torch_ckpt import convert_state_dict as jconvert
from sdfa_tpu_torch import api as tapi
from sdfa_tpu_torch.compat import convert_state_dict, load_torch_checkpoint

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

TOL_M = 1e-5

_STACKS = {"audio_encoder": "_model._audio_encoder._layers",
           "output_trunk": "_model._output_module._layers",
           "scale_head": "_model._output_module._scale_layers",
           "rotat_head": "_model._output_module._rotat_layers"}
_PCA = {"scale_pca": "_model._output_module._scale_pca",
        "rotat_pca": "_model._output_module._rotat_pca", "pca": "_model._output_module._pca"}
_SUBMODULES = {"lstm": "_lstm", "proj": "_proj", "conv_query": "_conv_query",
               "proj_key": "proj_key", "proj_qry": "proj_qry", "v": "v"}
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# modern → legacy module names (the inverse of the JAX package's _LEGACY_RENAMES),
# longest match first so that "_layers.10." is not taken for "_layers.1."
_TO_LEGACY = sorted([
    ("_ext_post_bn", "_ext_batch_norm"),
    ("_model._audio_encoder._layers.10.", "time_aggregator.layers.1."),
    ("_model._audio_encoder._layers.9.", "time_aggregator.layers.0."),
    ("_model._audio_encoder._layers.1.", "audio_encoder.layers.0."),
    ("_model._audio_encoder._layers.2.", "audio_encoder.layers.1."),
    ("_model._audio_encoder._layers.3.", "audio_encoder.layers.2."),
    ("_model._audio_encoder._layers.4.", "audio_encoder.layers.3."),
    ("_model._audio_encoder._layers.5.", "audio_encoder.layers.4."),
    ("_model._audio_encoder._layers.6.", "audio_encoder.layers.5."),
    ("_model._output_module._scale_layers", "anime_decoder.layers_scale"),
    ("_model._output_module._rotat_layers", "anime_decoder.layers_rotat"),
    ("_model._output_module._scale_pca", "anime_decoder.proj_scale"),
    ("_model._output_module._rotat_pca", "anime_decoder.proj_rotat"),
    ("_model._output_module._layers.", "anime_decoder.layers."),
], key=lambda kv: -len(kv[0]))


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val, np.float32)


def _layer_entry(rest, val, siblings):
    """One leaf under a stack's child → (reference name, torch-layout array)."""
    head, leaf = rest[:-1], rest[-1]
    if head and head[-1] in ("post_bn", "prev_bn"):
        return f"_ext_{head[-1]}.{_BN_LEAVES[leaf]}", val
    rnn = leaf.startswith(("w_ih", "w_hh", "b_ih", "b_hh"))
    if rnn:  # torch LSTM: weight (4H, in), flax (in, 4H)
        name = ("weight_" if leaf[0] == "w" else "bias_") + leaf[2:]
        arr = val.T if leaf[0] == "w" else val
    elif leaf in ("kernel", "kernel_v", "kernel_g"):
        conv = siblings[leaf.replace("_g", "_v")].ndim >= 3
        name = {"kernel": "weight", "kernel_v": "weight_v", "kernel_g": "weight_g"}[leaf]
        if leaf == "kernel_g":  # torch keeps g with the weight's rank
            arr = val.reshape((-1,) + (1,) * (siblings["kernel_v"].ndim - 1))
        else:
            arr = val if conv else val.T  # torch Linear (out, in), flax (in, out)
    else:
        name, arr = leaf, val
    prefix = "".join(_SUBMODULES[h] + "." for h in head)
    return prefix + name, arr


def reference_checkpoint(variables, path, legacy=False):
    """Write ``variables`` (nested flax collections of numpy arrays) as a
    reference framework checkpoint."""
    state = {}
    for col in ("params", "batch_stats"):
        leaves = dict(_walk(variables.get(col, {})))
        for path_, val in leaves.items():
            if path_[0] == "speaker_embedding":
                state["_model._speaker_embedding.weight"] = val
                continue
            stack, child, *rest = path_
            siblings = {p[-1]: v for p, v in leaves.items() if p[:-1] == path_[:-1]}
            name, arr = _layer_entry(tuple(rest), val, siblings)
            state[f"{_STACKS[stack]}.{child.rsplit('_', 1)[1]}.{name}"] = arr
    for path_, val in _walk(variables.get("constants", {})):
        state[f"{_PCA[path_[0]]}.{path_[1]}"] = val
    state = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    if legacy:
        def rename(key):
            for new, old in _TO_LEGACY:
                if new in key:
                    return key.replace(new, old)
            return key

        state = {rename(k): v for k, v in state.items()}
        state["hamm"] = torch.hamming_window(512)  # the published checkpoints' stray buffer
    torch.save({"epoch": 50, "global_step": 86751, "state": state, "optim_default": {}}, path)
    return path


def _assert_trees_equal(got, want):
    got, want = dict(_walk(got)), dict(_walk(want))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("refckpt")
    with task_pair(root, narrow=True) as (jtask, ttask, n_verts):
        yield root, jtask, ttask, n_verts, jax.device_get(jtask.variables)


@pytest.mark.parametrize("legacy", [False, True], ids=["modern-names", "legacy-names"])
def test_helper_writes_what_the_jax_converter_reads_back(pair, tmp_path, legacy):
    *_, variables = pair
    path = reference_checkpoint(variables, str(tmp_path / "ref.ckpt"), legacy)
    blob = torch.load(path, weights_only=True)
    assert ("hamm" in blob["state"]) == legacy
    assert any(k.startswith("anime_decoder.") for k in blob["state"]) == legacy
    state, meta = load_torch_checkpoint(path)
    assert meta == {"epoch": 50, "global_step": 86751} and "hamm" not in state
    for convert in (jconvert, convert_state_dict):
        params, stats, constants = convert(state)
        _assert_trees_equal({"params": params, "batch_stats": stats, "constants": constants},
                            variables)


@pytest.mark.parametrize("legacy", [False, True], ids=["modern-names", "legacy-names"])
def test_jax_and_port_load_task_agree_on_one_file(pair, tmp_path, legacy):
    root, jtask, ttask, n_verts, variables = pair
    run = tmp_path / "run"
    run.mkdir()
    jtask.hp.dump(str(run / "hparams.json"))  # both load_tasks read it beside the file
    path = reference_checkpoint(variables, str(run / "epoch0050-step086751.ckpt"), legacy)
    sig = _signal(0.8, 11)
    kw = dict(device_frontend=True, overlap_frontend=True)
    ts_j, want = japi.load_task(path, **kw).generate_vertices(sig, 2)
    port = tapi.load_task(path, device="cpu", **kw)
    ts_t, got = port.generate_vertices(sig, 2)
    assert list(ts_t) == list(ts_j) and got.shape == (len(ts_j), n_verts, 3)
    assert float(np.abs(got - np.asarray(want)).max()) <= TOL_M
    # the same weights as the flax bridge carries them: the same bits
    _, bridged = ttask.generate_vertices(sig, 2)
    np.testing.assert_array_equal(got, bridged)
