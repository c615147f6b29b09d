"""Frontend parity: sdfa_tpu_torch.audio vs sdfa_tpu.audio on the shipped
voca-dgrad settings (sr 8000, win 512, hop 64, 128 mels, 64-frame windows)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.audio import dsp as jdsp
from sdfa_tpu.audio import pipeline as jpipe
from sdfa_tpu.tools import configure as jconfigure
from sdfa_tpu_torch.audio import dsp as tdsp
from sdfa_tpu_torch.audio import pipeline as tpipe
from sdfa_tpu_torch.config import configure as tconfigure


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
