"""The port's host leftovers against the JAX package on the same seeded
inputs: ``utils/bilateral.py`` (within 1e-6, float64 in torch against
float64 numpy), ``utils/npext.py`` (equal), ``utils/log.py`` (the lines it
writes to a file, ``timeit`` and ``timed``), ``nn/precision.py`` (the library
flags of each setting; unset, today's full float32 bit for bit), and the
rest of ``audio/dsp.py`` with the feature registry ``audio/features.py``:
mel / spec / deepspeech_spec within 1e-4 of JAX (float32 products summed in
another order, amplified by the dB log near its floor, as
``tests/test_torch_frontend.py`` measures), ``lpc`` equal (the same float64
numpy), ``size`` equal."""

import importlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdfa_tpu.audio import dsp as jdsp
from sdfa_tpu.audio import features as jfeat
from sdfa_tpu.utils import BilateralFilter1D as JBilateral
from sdfa_tpu.utils import log as jlog
from sdfa_tpu.utils import npext as jnpext
from sdfa_tpu_torch import ops
from sdfa_tpu_torch.audio import dsp as tdsp
from sdfa_tpu_torch.audio import features as tfeat
from sdfa_tpu_torch.nn import precision
from sdfa_tpu_torch.utils import BilateralFilter1D, log, npext

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

FEATURE_TOL = 1e-4  # mel / spec / deepspeech_spec: port on the CPU vs JAX
BILATERAL_TOL = 1e-6


def _step_edge():
    """``tests/test_misc_components.py::TestBilateral``'s noisy step edge."""
    rng = np.random.default_rng(0)
    t = np.arange(200)
    return (np.where(t < 100, 0.0, 1.0) + rng.normal(0, 0.02, 200))[:, None]


@pytest.mark.parametrize("case", ["step_edge", "vertices"])
def test_bilateral_matches_jax(case):
    if case == "step_edge":
        seq, kw = _step_edge(), dict(radius=4, sigma_space=2.0, sigma_value=0.1)
    else:  # a vertex track: (T, V, 3) metres, the default widths
        rng = np.random.default_rng(1)
        seq, kw = (rng.normal(0, 0.05, (1, 40, 3)) + rng.normal(0, 0.002, (30, 40, 3)), {})
    want = JBilateral(**kw)(seq)
    got = BilateralFilter1D(**kw)(seq)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= BILATERAL_TOL
    on_tensor = BilateralFilter1D(**kw)(torch.from_numpy(seq))
    assert on_tensor.dtype == torch.float32 and torch.equal(on_tensor, torch.from_numpy(got))
    if case == "step_edge":  # the JAX test's own claims hold for the port too
        out = got[:, 0]
        assert out[:80].std() < seq[:80, 0].std()
        assert abs(out[110] - 1.0) < 0.1 and abs(out[90]) < 0.1


def test_npext_equal():
    rng = np.random.default_rng(2)
    arrays = [np.array([[0, 0, 3, 0, 5], [0, 0, 0, 0, 0]]),
              rng.integers(0, 3, (4, 6, 5)) * (rng.random((4, 6, 5)) < 0.3)]
    for arr in arrays:
        for axis in range(-arr.ndim, arr.ndim):
            for fn in ("first_nonzero", "last_nonzero"):
                np.testing.assert_array_equal(getattr(npext, fn)(arr, axis=axis),
                                              getattr(jnpext, fn)(arr, axis=axis))


def _drive(mod, path):
    mod.set_log_file(str(path))
    try:
        mod.info("hello", 3)
        mod.warn("careful")
        mod.error("bad", 1.5)
        with mod.timeit("block"):
            pass
        mod.timed("tagged")(lambda: None)()

        def named():
            return 7

        assert mod.timed()(named)() == 7
        with pytest.raises(SystemExit):
            mod.assertion(False, "broken")
        mod.assertion(True, "fine")
    finally:
        mod.set_log_file(None)
    return path.read_text().splitlines()


def test_log_file_lines_match_jax(tmp_path, capsys):
    want = _drive(jlog, tmp_path / "jax.log")
    got = _drive(log, tmp_path / "port.log")
    ms = re.compile(r"\d+\.\d\d ms$")
    assert [ms.sub("MS", line) for line in got] == [ms.sub("MS", line) for line in want]
    assert got[0] == "[INFO ] hello 3" and got[2] == "[ERROR] bad 1.5"
    assert got[-1] == "[FATAL] broken" and ms.search(got[3]) and got[3].startswith("[INFO ] block: ")
    assert got[5].startswith("[INFO ] _drive.<locals>.named: ")
    out = capsys.readouterr()
    assert "[INFO ] hello 3" in out.out and "[ERROR] bad 1.5" in out.err


def test_log_verbose_and_stdlib(tmp_path, capsys):
    log.set_verbose(False)
    try:
        log.info("quiet")
        log.error("loud")
    finally:
        log.set_verbose(True)
    out = capsys.readouterr()
    assert "quiet" not in out.out and "[ERROR] loud" in out.err
    logger = log._LOGGER
    assert logger.name == "sdfa_tpu_torch.log" and not logger.propagate


@pytest.fixture
def reload_precision(monkeypatch):
    """Reload ``nn/precision.py`` under the given variables; afterwards the
    module and the flags are what they were."""
    flags = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)

    def load(**env):
        for name in ("SDFA_MATMUL_PRECISION", "SDFA_OPS_PRECISION", "SDFA_CONV_PRECISION"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        return importlib.reload(precision)

    yield load
    monkeypatch.undo()
    importlib.reload(precision)
    torch.set_float32_matmul_precision(flags[0])
    torch.backends.cudnn.allow_tf32 = flags[1]


@pytest.mark.parametrize("env,matmul,conv_tf32", [
    ({}, "highest", False),
    ({"SDFA_MATMUL_PRECISION": "high"}, "high", True),
    ({"SDFA_MATMUL_PRECISION": "default"}, "medium", True),
    ({"SDFA_MATMUL_PRECISION": "high", "SDFA_CONV_PRECISION": "highest"}, "high", False),
    ({"SDFA_CONV_PRECISION": "DEFAULT"}, "highest", True),
    ({"SDFA_OPS_PRECISION": "default"}, "highest", False),  # read, no effect of its own
])
def test_precision_settings_give_their_library_flags(reload_precision, env, matmul, conv_tf32):
    mod = reload_precision(**env)
    torch.set_float32_matmul_precision("medium")  # not what any setting below leaves
    torch.backends.cudnn.allow_tf32 = not conv_tf32
    ops.full_float32()
    assert torch.get_float32_matmul_precision() == matmul
    assert torch.backends.cuda.matmul.allow_tf32 == (matmul != "highest")
    assert torch.backends.cudnn.allow_tf32 == conv_tf32
    assert mod.MODEL_PREC == {"medium": "default"}.get(matmul, matmul)


def test_precision_rejects_unknown_level(reload_precision):
    with pytest.raises(ValueError, match="SDFA_MATMUL_PRECISION"):
        reload_precision(SDFA_MATMUL_PRECISION="bf16")


def test_precision_unset_keeps_full_float32_numerics(reload_precision):
    """Unset variables leave the flags the port set before they existed
    (``allow_tf32`` off for matmul and cuDNN), and a narrow forward gives the
    same bits under both."""
    from test_torch_train_step import _torch_model

    from sdfa_tpu_torch.compat import init_params

    reload_precision()
    model = init_params(_torch_model(), 3).eval()
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.normal(0, 1, (4, 8, 16, 3)).astype(np.float32))
    spk = torch.zeros(4, dtype=torch.long)
    torch.backends.cuda.matmul.allow_tf32 = False  # what ops.full_float32 set before
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        before = model(feat, spk)[0]
        ops.full_float32()
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        after = model(feat, spk)[0]
    assert all(bool(torch.isfinite(v).all()) and torch.equal(v, after[k])
               for k, v in before.items())


def _clip(seconds=3.0, sr=8000, seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 170 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


# the dgrad audio config's mel and lpc sections with sizes in samples (the registry takes
# integer sizes), and spectrogram sections at the same frame
FEATURE_ARGS = {
    "sample_rate": 8000,
    "mel": dict(n_mels=128, win_size=512, hop_size=64, win_fn="hamm", padding=False, fmin=50,
                fmax=3600, ref_db=20, top_db=80, normalize=True, clip_normalized=True,
                subtract_mean=False, preemphasis=0.65),
    "spec": dict(win_size=512, hop_size=64, win_fn="hamm", ref_db=20, top_db=80,
                 normalize=True, subtract_mean=True, preemphasis=0.65),
    "deepspeech_spec": dict(win_size=512, hop_size=64, win_fn="hann", padding=True,
                            preemphasis=0.97),
    "lpc": dict(order=32, win_size=512, hop_size=64, win_fn="hamm", preemphasis=0.65),
}
NAMES = ["mel", "spec", "deepspeech_spec", "lpc"]


@pytest.fixture(scope="module")
def features():
    sig = _clip()
    return (jfeat.get_dict(NAMES, sig, FEATURE_ARGS), tfeat.get_dict(NAMES, sig, FEATURE_ARGS),
            tfeat.get_dict(NAMES, torch.from_numpy(sig), FEATURE_ARGS))


@pytest.mark.parametrize("name", NAMES)
def test_feature_matches_jax(features, name):
    want, got, got_t = (f[name] for f in features)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[0] == tfeat.size(name, FEATURE_ARGS[name])
    assert tfeat.size(name, FEATURE_ARGS[name]) == jfeat.size(name, FEATURE_ARGS[name])
    if name == "lpc":
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.abs(got - want).max()) <= FEATURE_TOL
    assert torch.is_tensor(got_t) and np.array_equal(got_t.numpy(), got)


def test_feature_registry_refusals():
    with pytest.raises(KeyError, match="not supported"):
        tfeat.get("mfcc", _clip(0.2), 8000)
    with pytest.raises(KeyError, match="no arg sub-dict"):
        tfeat.get_dict(["mel"], _clip(0.2), {"sample_rate": 8000})
    with pytest.raises(NotImplementedError):
        tfeat.size("mfcc", {})


def test_dsp_remainder_matches_jax():
    rng = np.random.default_rng(5)
    sig = _clip(0.5)
    for padding in (False, True):
        want = np.asarray(jdsp.stft_power(jnp.asarray(sig), 256, 64, "hann", padding))
        got = tdsp.stft_power(torch.from_numpy(sig), 256, 64, "hann", padding).numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= FEATURE_TOL * max(1.0, float(want.max()))
    feat = rng.normal(0, 1, (2, 12, 30)).astype(np.float32)
    for order in (1, 2):
        np.testing.assert_allclose(tdsp.delta(torch.from_numpy(feat), order).numpy(),
                                   np.asarray(jdsp.delta(jnp.asarray(feat), order)), atol=1e-5)
    stacked = tdsp.add_deltas(torch.from_numpy(feat)).numpy()
    assert stacked.shape == (2, 3, 12, 30)
    np.testing.assert_allclose(stacked, np.asarray(jdsp.add_deltas(jnp.asarray(feat))), atol=1e-5)
    db = rng.normal(-20, 10, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(tdsp.db_to_power(torch.from_numpy(db)).numpy(),
                               np.asarray(jdsp.db_to_power(jnp.asarray(db))), rtol=1e-6)
    np.testing.assert_allclose(tdsp.denormalize_db(torch.from_numpy(db), 20, 80).numpy(),
                               np.asarray(jdsp.denormalize_db(jnp.asarray(db), 20, 80)),
                               rtol=1e-6)
    for fn in ("mel_spectrogram", "spectrogram"):
        kw = dict(sr=8000, win_size=512, hop_size=64, preemph=0.65, normalize=True, top_db=80)
        want = np.asarray(getattr(jdsp, fn)(sig, **kw))
        got = getattr(tdsp, fn)(torch.from_numpy(sig), **kw).numpy()
        assert float(np.abs(got - want).max()) <= FEATURE_TOL
