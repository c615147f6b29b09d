"""The port's audio helpers that no other test names, against their
``sdfa_tpu/audio/`` originals on the same seeded inputs: the noise
generators and mu-law companding of ``audio/misc.py`` bit for bit (the same
``np.random.Generator`` seed on both sides), and ``deemphasis`` and the
Griffin-Lim inversions of ``audio/dsp.py`` (few iterations, a 0.25 s
signal). Both sides are the same numpy code, so the inversions are held to
1e-6 of the signal's scale, float32 grade, though they come out equal; the
package exports are the JAX package's names."""

import numpy as np
import pytest

import sdfa_tpu.audio as jaudio
from sdfa_tpu.audio import dsp as jdsp
from sdfa_tpu.audio import misc as jmisc
import sdfa_tpu_torch.audio as taudio
from sdfa_tpu_torch.audio import dsp as tdsp
from sdfa_tpu_torch.audio import misc as tmisc
from sdfa_tpu_torch.data import features_host

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

SR, WIN, HOP = 8000, 256, 64
INV_TOL = 1e-6  # an inverted waveform, port vs JAX, max abs (signal within ±1)


def _signal(seconds=0.25, seed=5):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    sig = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


def test_package_exports_the_jax_names():
    assert set(jaudio.__all__) <= set(taudio.__all__)
    for name in ("white_noise", "pink_noise", "mulaw", "inv_mulaw", "mu_quantize",
                 "mu_normalize", "detect_speech", "vad_to_pairs", "vad_from_pairs"):
        assert getattr(taudio, name) is getattr(tmisc, name), name
    assert taudio.misc is tmisc
    # the host features' augmentation draws from the same generator
    assert features_host.pink_noise is tmisc.pink_noise


@pytest.mark.parametrize("length,scale,seed", [(1, 1.0, 0), (4000, 0.05, 3), (257, 2.5, 11)])
def test_white_noise_bit_for_bit(length, scale, seed):
    got = tmisc.white_noise(length, scale, rng=np.random.default_rng(seed))
    want = jmisc.white_noise(length, scale, rng=np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nrows,scale,ncols,seed", [(1, 1.0, 16, 0), (2000, 0.1, 16, 4),
                                                    (513, 1.0, 5, 9)])
def test_pink_noise_bit_for_bit(nrows, scale, ncols, seed):
    got = tmisc.pink_noise(nrows, scale, ncols, rng=np.random.default_rng(seed))
    want = jmisc.pink_noise(nrows, scale, ncols, rng=np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.float32 and got.shape == (nrows,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb_mu", [255, 1023])
def test_mulaw_companding_bit_for_bit(nb_mu):
    y = np.random.default_rng(nb_mu).uniform(-1, 1, 1000).astype(np.float32)
    y[:3] = (-1.0, 0.0, 1.0)
    c_t, c_j = tmisc.mulaw(y, nb_mu), jmisc.mulaw(y, nb_mu)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(tmisc.inv_mulaw(c_t, nb_mu), jmisc.inv_mulaw(c_j, nb_mu))
    q_t, q_j = tmisc.mu_quantize(c_t, nb_mu), jmisc.mu_quantize(c_j, nb_mu)
    assert q_t.dtype == q_j.dtype == np.int64
    np.testing.assert_array_equal(q_t, q_j)
    n_t, n_j = tmisc.mu_normalize(q_t, nb_mu), jmisc.mu_normalize(q_j, nb_mu)
    assert n_t.dtype == n_j.dtype == np.float32
    np.testing.assert_array_equal(n_t, n_j)


@pytest.mark.parametrize("a", [0.0, 0.65, 0.97])
def test_deemphasis_matches_jax(a):
    sig = _signal()
    got, want = tdsp.deemphasis(sig, a), jdsp.deemphasis(sig, a)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=INV_TOL)


def _db_spec(sig):
    """A normalized-dB power spectrogram (freq, frames) of ``sig``, the
    numpy way (the inversions' input)."""
    window = np.hamming(WIN + 1)[:-1]
    padded = np.pad(sig.astype(np.float64), WIN // 2)
    n = 1 + (len(padded) - WIN) // HOP
    idx = np.arange(n)[:, None] * HOP + np.arange(WIN)[None, :]
    power = np.abs(np.fft.rfft(padded[idx] * window, axis=1).T) ** 2
    return power, 10 * np.log10(np.maximum(power, 1e-10))


@pytest.mark.parametrize("n_iter,seed", [(1, 0), (4, 3)])
def test_griffin_lim_matches_jax(n_iter, seed):
    mag = np.sqrt(_db_spec(_signal())[0])
    got = tdsp.griffin_lim(mag, WIN, HOP, "hamm", n_iter, seed)
    want = jdsp.griffin_lim(mag, WIN, HOP, "hamm", n_iter, seed)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=INV_TOL)


@pytest.mark.parametrize("normalize,preemph", [(False, 0.0), (True, 0.65)])
def test_inv_spectrogram_matches_jax(normalize, preemph):
    db = _db_spec(_signal())[1]
    if normalize:  # the inverse of the dB normalization inv_spectrogram undoes
        db = (db - 20 + 100) / 100
    kw = dict(win_fn="hamm", ref_db=20, top_db=100, normalize=normalize, n_iter=3,
              preemph=preemph)
    got = tdsp.inv_spectrogram(db, SR, WIN, HOP, **kw)
    want = jdsp.inv_spectrogram(db, SR, WIN, HOP, **kw)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=INV_TOL)


@pytest.mark.parametrize("n_mels,fmax", [(40, 3600), (80, 4000)])
def test_inv_mel_spectrogram_matches_jax(n_mels, fmax):
    power = _db_spec(_signal())[0]
    mel = np.asarray(jdsp.mel_filters(SR, WIN, n_mels, 50, fmax), np.float64) @ power
    db = 10 * np.log10(np.maximum(mel, 1e-10))
    kw = dict(win_fn="hamm", n_mels=n_mels, fmin=50, fmax=fmax, ref_db=20, top_db=100,
              normalize=False, n_iter=3, preemph=0.65)
    got = tdsp.inv_mel_spectrogram(db, SR, WIN, HOP, **kw)
    want = jdsp.inv_mel_spectrogram(db, SR, WIN, HOP, **kw)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=INV_TOL)
