"""Weight bridge and flagship forward parity: every parameter, batch
statistic and PCA constant of the shipped dgrad model crosses from the
flax tree into sdfa_tpu_torch by name, and the port's forward then equals
both the JAX forward and the reference-faithful ``TorchTwin`` within the
5e-5-per-branch budget of tests/test_e2e_parity.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _assets import ensure_pca_assets
from test_e2e_parity import TorchTwin
from test_torch_nn import _perturb

from sdfa_tpu.models import build_model as jbuild
from sdfa_tpu.models.sdfa import SpeechDrivenAnimation as JModel
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu_torch.compat import init_params, load_flax_variables, state_dict_from_flax
from sdfa_tpu_torch.config import configure as tconfigure
from sdfa_tpu_torch.models import build_model as tbuild

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

BUDGET = 5e-5


@pytest.fixture(scope="module")
def flagship():
    root = ensure_pca_assets()
    hp = jconfigure("dgrad", dataset_root=root)
    jmodel = jbuild(hp, load_pca=True)
    rng = np.random.default_rng(0)
    feats = rng.normal(0.4, 0.2, (2, 64, 128, 3)).astype(np.float32)
    spk = np.asarray([1, 3], np.int32)
    k = jax.random.PRNGKey(42)
    variables = jax.device_get(jmodel.init({"params": k, "dropout": k},
                                           jnp.asarray(feats), jnp.asarray(spk), False))
    variables = _perturb(variables, rng)
    tmodel = load_flax_variables(tbuild(tconfigure("dgrad", dataset_root=root)), variables)
    return jmodel, variables, tmodel.eval(), feats, spk


def test_bridge_covers_every_parameter(flagship):
    _, variables, tmodel, *_ = flagship
    sd = state_dict_from_flax(variables)
    own = tmodel.state_dict()
    assert sorted(sd) == sorted(own)
    for key, val in sd.items():
        assert own[key].shape == val.shape, key
        torch.testing.assert_close(own[key], val, rtol=0, atol=0)
    n_params = sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert n_params == sum(p.numel() for p in tmodel.parameters())


def _port_branches(tmodel, feats, spk):
    with torch.no_grad():
        preds, _ = tmodel(torch.from_numpy(feats), torch.from_numpy(spk))
        return (tmodel.scale_pca(preds["dgrad_3d_scale_pca"])[:, 0].numpy(),
                tmodel.rotat_pca(preds["dgrad_3d_rotat_pca"])[:, 0].numpy())


def test_forward_matches_torch_twin(flagship):
    _, variables, tmodel, feats, spk = flagship
    twin = TorchTwin(variables)
    with torch.no_grad():
        ref_s, ref_r = twin(torch.from_numpy(feats), torch.from_numpy(spk))
    got_s, got_r = _port_branches(tmodel, feats, spk)
    assert float(np.abs(got_s - ref_s[:, 0].numpy()).max()) < BUDGET
    assert float(np.abs(got_r - ref_r[:, 0].numpy()).max()) < BUDGET


def test_forward_matches_jax(flagship):
    jmodel, variables, tmodel, feats, spk = flagship
    preds, _, _ = jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(spk), False)
    got_s, got_r = _port_branches(tmodel, feats, spk)
    assert float(np.abs(got_s - np.asarray(preds["dgrad_3d_scale"])[:, 0]).max()) < BUDGET
    assert float(np.abs(got_r - np.asarray(preds["dgrad_3d_rotat"])[:, 0]).max()) < BUDGET


def test_overlap_path_and_decode_match_jax(flagship):
    """encode_frames → forward_windows(raw_pca) → decode_to_anime, in both
    layouts, against the JAX methods on the same clip-level features."""
    jmodel, variables, tmodel, _, _ = flagship
    rng = np.random.default_rng(5)
    clip = rng.normal(0.4, 0.2, (80, 128, 3)).astype(np.float32)
    frame_idx = (np.arange(5)[:, None] * 3 + np.arange(64)[None, :]).astype(np.int32)
    spk = np.asarray([0, 2, 4, 6, 7], np.int32)
    z = jmodel.apply(variables, jnp.asarray(clip), method=JModel.encode_frames)
    jpreds, _, _ = jmodel.apply(variables, z, jnp.asarray(frame_idx), jnp.asarray(spk),
                                raw_pca=True, method=JModel.forward_windows)
    with torch.no_grad():
        tz = tmodel.encode_frames(torch.from_numpy(clip))
        tpreds, _, _ = tmodel.forward_windows(tz, torch.from_numpy(frame_idx).long(),
                                              torch.from_numpy(spk).long(), raw_pca=True)
        assert float(np.abs(tz.numpy() - np.asarray(z)).max()) < BUDGET
        for key in ("dgrad_3d_scale_pca", "dgrad_3d_rotat_pca"):
            assert float(np.abs(tpreds[key].numpy() - np.asarray(jpreds[key])).max()) < BUDGET
        for planes in (False, True):
            want = np.asarray(jmodel.decode_to_anime(variables, jpreds, planes=planes))
            got = tmodel.decode_to_anime(tpreds, planes=planes).numpy()
            assert float(np.abs(got - want).max()) < BUDGET


def test_encode_frames_batch_matches_per_clip_and_jax(flagship):
    """``encode_frames_batch`` on (B, T, F, C) is ``encode_frames`` per clip
    (the prefix is per frame; only the batch a product runs at differs) and
    the JAX method's output."""
    jmodel, variables, tmodel, _, _ = flagship
    clips = np.random.default_rng(6).normal(0.4, 0.2, (3, 24, 128, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(clips),
                                   method=JModel.encode_frames_batch))
    with torch.no_grad():
        got = tmodel.encode_frames_batch(torch.from_numpy(clips)).numpy()
        each = np.stack([tmodel.encode_frames(torch.from_numpy(c)).numpy() for c in clips])
    assert got.shape == want.shape == each.shape == (3, 24, 256)
    assert float(np.abs(got - each).max()) < 1e-5
    assert float(np.abs(got - want).max()) < BUDGET


def test_forward_windows_returns_latent_and_decoded_preds(flagship):
    """``forward_windows`` returns (preds, z, aligns) as the reference does;
    without ``raw_pca`` the predictions are the decoded flat frames, and
    ``decode_to_anime`` takes either kind by its keys."""
    jmodel, variables, tmodel, _, _ = flagship
    rng = np.random.default_rng(7)
    clip = rng.normal(0.4, 0.2, (70, 128, 3)).astype(np.float32)
    frame_idx = (np.arange(3)[:, None] * 2 + np.arange(64)[None, :]).astype(np.int32)
    spk = np.asarray([1, 3, 5], np.int32)
    z = jmodel.apply(variables, jnp.asarray(clip), method=JModel.encode_frames)
    jpreds, jz, jal = jmodel.apply(variables, z, jnp.asarray(frame_idx), jnp.asarray(spk),
                                   method=JModel.forward_windows)
    with torch.no_grad():
        tz = tmodel.encode_frames(torch.from_numpy(clip))
        args = (tz, torch.from_numpy(frame_idx).long(), torch.from_numpy(spk).long())
        preds, z_audio, aligns = tmodel.forward_windows(*args)
        raw, _, _ = tmodel.forward_windows(*args, raw_pca=True)
        assert set(preds) == set(jpreds) == {"dgrad_3d_scale", "dgrad_3d_rotat"}
        for key in preds:
            assert float(np.abs(preds[key].numpy() - np.asarray(jpreds[key])).max()) < BUDGET
        assert float(np.abs(z_audio.numpy() - np.asarray(jz)).max()) < BUDGET
        assert list(aligns) == list(jal)
        for key in aligns:
            assert float(np.abs(aligns[key].numpy() - np.asarray(jal[key])).max()) < BUDGET
        np.testing.assert_array_equal(tmodel.decode_to_anime(preds).numpy(),
                                      tmodel.decode_to_anime(raw).numpy())


def test_init_params_is_seeded(flagship):
    *_, tmodel, _, _ = flagship
    a = init_params(tbuild(tconfigure("dgrad", dataset_root=ensure_pca_assets())), 3)
    b = init_params(tbuild(tconfigure("dgrad", dataset_root=ensure_pca_assets())), 3)
    c = init_params(tbuild(tconfigure("dgrad", dataset_root=ensure_pca_assets())), 4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert sorted(sa) == sorted(tmodel.state_dict())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    key = "audio_encoder.built_layers_9.w_hh_l0"
    assert not torch.equal(sa[key], sc[key])
    fc = a.scale_head.built_layers_1  # weight norm starts at g = ‖v‖
    torch.testing.assert_close(fc.kernel_g, fc.kernel_v.norm(dim=0))
