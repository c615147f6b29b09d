"""Frontend parity: sdfa_tpu_torch.audio vs sdfa_tpu.audio on the shipped
voca-dgrad settings (sr 8000, win 512, hop 64, 128 mels, 64-frame windows)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdfa_tpu.audio import dsp as jdsp
from sdfa_tpu.audio import pipeline as jpipe
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu_torch.audio import dsp as tdsp
from sdfa_tpu_torch.audio import pipeline as tpipe
from sdfa_tpu_torch.config import configure as tconfigure

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)


@pytest.fixture(scope="module")
def specs():
    return jpipe.WindowSpec(jconfigure("dgrad")), tpipe.WindowSpec(tconfigure("dgrad"))


@pytest.mark.parametrize("n_samples", [0, 1, 4000, 7200, 12345, 24000])
@pytest.mark.parametrize("bucket", [0, 256])
def test_frame_grid_identical(specs, n_samples, bucket):
    jspec, tspec = specs
    j_idx, j_ts, *j_rest = jspec.frame_grid(n_samples, bucket=bucket)
    t_idx, t_ts, *t_rest = tspec.frame_grid(n_samples, bucket=bucket)
    np.testing.assert_array_equal(t_idx, j_idx)
    assert t_ts == j_ts
    assert t_rest == j_rest  # pad_left, pad_right, t_total


def test_host_constants_identical(specs):
    _, s = specs
    for a, b in zip(tdsp.dft_bases(s.win_size), jdsp.dft_bases(s.win_size)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tdsp.mel_filters(s.sr, s.win_size, s.n_mels, s.fmin, s.fmax),
        jdsp.mel_filters(s.sr, s.win_size, s.n_mels, s.fmin, s.fmax))
    np.testing.assert_array_equal(tdsp.get_window(s.win_fn, s.win_size),
                                  jdsp.get_window(s.win_fn, s.win_size))
    for order in (1, 2):
        np.testing.assert_array_equal(tdsp.delta_matrix(40, order),
                                      jdsp.delta_matrix(40, order))


@pytest.mark.parametrize("seconds", [0.4, 1.1])
def test_clip_features_match_jax(specs, seconds):
    jspec, tspec = specs
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * tspec.sr)) / tspec.sr
    sig = (0.3 * np.sin(2 * np.pi * 170 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
           + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
    _, _, pad_l, pad_r, t_total = tspec.frame_grid(len(sig), bucket=256)
    padded = np.pad(sig, (pad_l, pad_r))
    want = np.asarray(jpipe.clip_frame_features_padded(jnp.asarray(padded), jspec))
    got = tpipe.clip_frame_features_padded(torch.from_numpy(padded), tspec).numpy()
    assert got.shape == want.shape == (t_total, 128, 3)
    # f32 both sides; the DFT/mel/delta products sum in another order and
    # log10 amplifies that near the dB floor: measured 8.5e-6 on the
    # normalized O(1) mel channel, bound 1e-4
    assert float(np.abs(got - want).max()) < 1e-4


def _clip(seconds, seed, sr=8000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 170 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_constants_cache_is_bit_equal_and_bounded(specs):
    """The frontend with its constants kept on the device gives the bits of
    the same products on freshly uploaded constants (what the port did before
    it kept them), hands out one tensor per constant, and holds few."""
    _, s = specs
    sig = _clip(0.5, 3)
    _, _, pad_l, pad_r, t_total = s.frame_grid(len(sig), bucket=256)
    padded = torch.from_numpy(np.pad(sig, (pad_l, pad_r)))

    def up(a):
        return torch.from_numpy(a)

    frames = tdsp.frame_signal(tdsp.preemphasis(padded, s.preemph), s.win_size, s.hop_size)
    frames = frames * up(tdsp.get_window(s.win_fn, s.win_size))
    cos_b, sin_b = tdsp.dft_bases(s.win_size)
    re, im = frames @ up(cos_b), frames @ up(sin_b)
    mel = tdsp.power_to_db((re * re + im * im) @ up(
        tdsp.mel_filters(s.sr, s.win_size, s.n_mels, s.fmin, s.fmax)).T)
    feat = tdsp.normalize_db(mel, s.ref_db, s.top_db, s.clip).T
    want = torch.stack([feat, feat @ up(tdsp.delta_matrix(t_total, 1)),
                        feat @ up(tdsp.delta_matrix(t_total, 2))], dim=-1).transpose(0, 1)

    tpipe.clear_const_cache()
    cold = tpipe.clip_frame_features_padded(padded, s)
    held = dict(tpipe._CONSTS)
    assert len(held) == 6  # window, two DFT bases, mel filters, Δ and Δ² at this frame count
    warm = tpipe.clip_frame_features_padded(padded, s)
    assert torch.equal(cold, want) and torch.equal(warm, want)
    assert all(tpipe._CONSTS[k] is v for k, v in held.items())  # nothing uploaded again
    for t in range(20, 20 + 2 * tpipe._CONSTS_MAX):
        tpipe._delta_const(t, 1, padded)
    assert len(tpipe._CONSTS) == tpipe._CONSTS_MAX
    assert torch.equal(tpipe.clip_frame_features_padded(padded, s), want)


def test_batched_clip_features_match_per_clip_and_vmap(specs):
    jspec, tspec = specs
    sigs = np.stack([_clip(0.6, k) for k in range(3)])
    _, _, pad_l, pad_r, t_total = tspec.frame_grid(sigs.shape[1], bucket=256)
    got = tpipe.clip_frame_features_device(torch.from_numpy(sigs), tspec, pad_l, pad_r).numpy()
    assert got.shape == (3, t_total, 128, 3)
    for k in range(3):
        one = tpipe.clip_frame_features_device(torch.from_numpy(sigs[k]), tspec, pad_l, pad_r)
        assert float(np.abs(got[k] - one.numpy()).max()) < 1e-5
    want = np.asarray(jax.vmap(lambda x: jpipe.clip_frame_features_device(
        x, jspec, pad_l, pad_r))(jnp.asarray(sigs)))
    assert float(np.abs(got - want).max()) < 1e-4  # as test_clip_features_match_jax


def test_window_features_and_energy_match_jax(specs):
    """The exact per-window frontend: features (W, T, F, 3) and the RMS energy
    track of ``fetch_audio_features_device``, bound 1e-4 as for the clip
    features (energy is a plain mean: 1e-6)."""
    jspec, tspec = specs
    sig = _clip(0.45, 5)
    want = jpipe.fetch_audio_features_device(sig, jconfigure("dgrad"))
    got = tpipe.fetch_audio_features_device(sig, tspec, "cpu")
    assert got["tslist"] == want["tslist"]
    assert got["audio_feat"].shape == np.asarray(want["audio_feat"]).shape
    assert got["audio_feat"].shape[1:] == (64, 128, 3)
    assert float(np.abs(got["audio_feat"].numpy() - np.asarray(want["audio_feat"])).max()) < 1e-4
    assert float(np.abs(got["energy"].numpy() - np.asarray(want["energy"])).max()) < 1e-6
    x = torch.from_numpy(sig[:4096])
    np.testing.assert_allclose(tdsp.rms_energy(x, 512, 64).numpy(),
                               np.asarray(jdsp.rms_energy(jnp.asarray(sig[:4096]), 512, 64)),
                               atol=1e-6)
