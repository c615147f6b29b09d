"""Routes of the recurrent layers on a card, chosen from the shape alone
before anything launches, as the JAX modules gate their Pallas kernels: a
kernel wherever one of the port's takes the shape — every shape JAX runs a
Pallas kernel at (any H that is a multiple of 128, any input and output
width), and the inputs JAX scans at such an H — else the plain recurrence,
where JAX takes its scan too, counted in ``ops.PLAIN_ROUTES``. On the CPU
every layer goes through its wrapper. The route
functions are asserted directly; the modules run with the card check stubbed
and every wrapper and plain version replaced by a recorder that returns
zeros of the right shape, so nothing is launched or computed.
"""

import types

import pytest
import torch

from sdfa_tpu_torch import ops
from sdfa_tpu_torch.nn import recurrent as trec
from sdfa_tpu_torch.ops import bilstm_core as K5mod
from sdfa_tpu_torch.ops import bilstm_layer as K4mod
from sdfa_tpu_torch.ops import freq_lstm as K1mod

import _torch_threads  # noqa: F401  (one intra-op thread per xdist worker)

K2, K4, K5, P = "bilstm2", "bilstm_layer", "bilstm_core", trec.PLAIN


@pytest.mark.parametrize("hidden,sizes,training,want", [
    (256, [256, 512], False, (K2, K2)),          # the shipped time stack
    (128, [64, 256], False, (K2, K2)),           # the width the kernels gained
    (128, [64], False, (K4,)),                   # FreqLstm "last", LSTM2d
    (128, [100], False, (K4,)),                  # JAX scans (in 100); a port kernel takes it
    (256, [256, 512, 512], False, (K4, K4, K4)),
    (256, [520, 512], False, (K2, K2)),          # JAX scans layer 0; the port's K2 takes both
    (128, [513, 256], False, (K2, K2)),
    (192, [64, 384], False, (P, P)),             # H = 192: JAX scans too
    (128, [64, 256], True, (K5, K5)),
    (256, [2048], True, (K5,)),                  # the core takes any input width
    (96, [64], True, (P,)),
    (192, [64], True, (P,)),
    # what the port refused until the wide step loop (H = 384 and up, inputs past 512)
    (256, [1024, 512], False, (K2, K2)),
    (128, [640], False, (K4,)),
    (384, [256], False, (K4,)),
    (512, [512, 1024], False, (K2, K2)),
    (384, [256], True, (K5,)),
    (512, [64], True, (K5,)),
    (640, [64, 1280], False, (K2, K2)),         # H = 640: 40 runs of 16 units
    (640, [64], True, (K5,)),
    (512, [1024], False, (K4,)),                 # an input of 1024 at H = 512
])
def test_bilstm_routes_on_a_card(hidden, sizes, training, want):
    assert trec.bilstm_routes(hidden, sizes, training) == want


@pytest.mark.parametrize("hidden,out,want", [
    (128, 256, "freq_lstm"), (64, 256, P), (192, 256, P),
    (128, 128, "freq_lstm"),                     # JAX runs its kernel at any out
    (128, 200, "freq_lstm"),
    (256, 256, "freq_lstm"), (256, 512, "freq_lstm"), (384, 384, "freq_lstm"),
])
def test_freq_route(hidden, out, want):
    """The kernel at any H that is a multiple of 128 and any out (and any input
    width: JAX scans an input that is no multiple of 8, the port's kernel
    takes it); the plain recurrence elsewhere, as JAX scans."""
    assert trec.freq_route(hidden, out) == want


def test_no_shape_the_jax_gate_sends_to_a_kernel_is_refused():
    """Every (H, in, out) the JAX gates at ``sdfa_tpu/nn/recurrent.py:236-238,
    293-304, 427-435`` send to a Pallas kernel routes to a kernel of the port
    on a card, in eval and in training; no route raises."""
    for hid in range(128, 2048 + 1, 128):
        for n_in in (8, 128, 384, 512, 1024, 2 * hid, 4096):
            for layers in (1, 2, 3):
                sizes = [n_in] + [2 * hid] * (layers - 1)
                assert trec.PLAIN not in trec.bilstm_routes(hid, sizes, False), (hid, sizes)
                assert trec.bilstm_routes(hid, sizes, True) == ("bilstm_core",) * layers
        for out in (1, 7, 200, 256, 384, 512, 1000):
            assert trec.freq_route(hid, out) == "freq_lstm"
            assert K1mod.takes(hid, out)
        assert K4mod.takes(hid, 1) and K5mod.takes(hid)


def _stubs(monkeypatch, card=True):
    """Recorders in place of every wrapper and plain version; the card check
    says yes if ``card`` (outside ``ops.plain_versions()``); the plain routes ``ops.plain_route`` would count are recorded
    as "counted"."""
    calls = []

    def layer(name):
        def fn(x, w_ih, w_hh, gb):
            calls.append(name)
            return x.new_zeros(x.shape[0], x.shape[1], 2 * w_hh.shape[1])
        return fn

    def two(name):
        def fn(x, w_ih1, w_hh1, gb1, w_ih2, w_hh2, gb2):
            calls.append(name)
            return x.new_zeros(x.shape[0], x.shape[1], 2 * w_hh1.shape[1])
        return fn

    def core(name):
        def fn(xp, w_hh):
            calls.append(name)
            return xp.new_zeros(xp.shape[1], xp.shape[2], 2 * w_hh.shape[1])
        return fn

    def freq(name):
        def fn(rows, w_ih, w_hh, gb, w_proj, b_proj):
            calls.append(name)
            return rows.new_zeros(rows.shape[0], w_proj.shape[1])
        return fn

    for attr, fn in (("bilstm_layer", layer("K4")), ("bilstm_layer_plain", layer("plain")),
                     ("bilstm2", two("K2")), ("bilstm2_plain", two("plain2")),
                     ("bilstm_core", core("K5")), ("bilstm_core_plain", core("plain_core")),
                     ("freq_lstm", freq("K1")), ("freq_lstm_plain", freq("plain_freq"))):
        monkeypatch.setattr(trec, attr, fn)
    if card:
        monkeypatch.setattr(trec, "on_card", lambda x: not ops.using_plain())
    monkeypatch.setattr(trec.ops, "plain_route",
                        lambda x: None if ops.using_plain() else calls.append("counted"))
    return calls


MODULES = [
    ("lstm H128 x2", lambda: trec.LSTM(64, 128, 2, bidirectional=True), (2, 3, 64), False,
     ["K2"]),
    ("lstm H256 x3", lambda: trec.LSTM(256, 256, 3, bidirectional=True), (2, 3, 256), False,
     ["K4"] * 3),
    ("lstm in 1024", lambda: trec.LSTM(1024, 256, 2, bidirectional=True), (2, 3, 1024), False,
     ["K2"]),
    ("lstm in 520", lambda: trec.LSTM(520, 256, 2, bidirectional=True), (2, 3, 520), False,
     ["K2"]),
    ("lstm H192", lambda: trec.LSTM(64, 192, 2, bidirectional=True), (2, 3, 64), False,
     ["counted", "plain", "counted", "plain"]),
    ("lstm H384", lambda: trec.LSTM(128, 384, 1, bidirectional=True), (2, 3, 128), False,
     ["K4"]),
    ("lstm H384 in 64", lambda: trec.LSTM(64, 384, 1, bidirectional=True), (2, 3, 64), False,
     ["K4"]),                                    # JAX scans: in 64 is not a multiple of 128
    ("lstm H512 x3", lambda: trec.LSTM(512, 512, 3, bidirectional=True), (2, 3, 512), False,
     ["K4"] * 3),
    ("lstm H640 x2", lambda: trec.LSTM(64, 640, 2, bidirectional=True), (2, 3, 64), False,
     ["K2"]),
    ("lstm H384 train", lambda: trec.LSTM(64, 384, 3, bidirectional=True), (2, 3, 64), True,
     ["K5"] * 3),
    ("lstm H128 train", lambda: trec.LSTM(64, 128, 2, bidirectional=True), (2, 3, 64), True,
     ["K5", "K5"]),
    ("lstm H96 train", lambda: trec.LSTM(64, 96, 1, bidirectional=True), (2, 3, 64), True,
     ["counted", "plain_core"]),
    ("freq full", lambda: trec.FreqLstm(64, 4, 128, 256), (2, 64, 4, 3), False, ["K1"]),
    ("freq out 128", lambda: trec.FreqLstm(64, 4, 128, 128), (2, 64, 4, 3), False, ["K1"]),
    ("freq in 3 out 128", lambda: trec.FreqLstm(3, 4, 128, 128), (2, 3, 4, 3), False,
     ["K1"]),
    ("freq H256 out 512", lambda: trec.FreqLstm(64, 4, 256, 512), (2, 64, 4, 3), False, ["K1"]),
    ("freq H384 train", lambda: trec.FreqLstm(64, 4, 384, 384), (2, 64, 4, 3), True, ["K5"]),
    ("freq H64", lambda: trec.FreqLstm(64, 4, 64, 100), (2, 64, 4, 3), False,
     ["counted", "plain_freq"]),                 # JAX scans: H 64
    ("freq last", lambda: trec.FreqLstm(64, 4, 128, 256, mode="last"), (2, 64, 4, 3), False,
     ["K4"]),
    ("freq last train", lambda: trec.FreqLstm(64, 4, 128, 256, mode="last"), (2, 64, 4, 3),
     True, ["K5"]),
    ("lstm2d", lambda: trec.LSTM2d(64, 128, 2), (2, 64, 4, 3), False, ["K4", "K4"]),
    ("lstm2d train", lambda: trec.LSTM2d(64, 128, 2), (2, 64, 4, 3), True, ["K5", "K5"]),
    ("lstm2d H256 in 64", lambda: trec.LSTM2d(64, 256, 3), (2, 64, 4, 3), False,
     ["K4", "K4", "K4"]),
]


@pytest.mark.parametrize("name,make,shape,training,want", MODULES, ids=[m[0] for m in MODULES])
def test_module_routes(monkeypatch, name, make, shape, training, want):
    """The card's routes; under ``ops.plain_versions()`` every layer takes its
    plain version, counted nowhere, whatever the shape."""
    calls = _stubs(monkeypatch)
    mod = make().train(training)
    with torch.no_grad():
        mod(torch.zeros(shape))
    assert calls == want
    calls.clear()
    with ops.plain_versions(), torch.no_grad():
        mod(torch.zeros(shape))
    assert calls and "counted" not in calls and not any(c.startswith("K") for c in calls)


def test_on_the_cpu_every_layer_goes_through_its_wrapper(monkeypatch):
    """Every CPU wrapper is its plain version, so the CPU never routes around
    one, even at a shape the card takes the plain recurrence at."""
    calls = _stubs(monkeypatch, card=False)
    cases = [(trec.LSTM(64, 384, 2, bidirectional=True), (2, 3, 64), False, ["K4", "K4"]),
             (trec.LSTM(1024, 256, 1, bidirectional=True), (2, 3, 1024), False, ["K4"]),
             (trec.LSTM(64, 96, 2, bidirectional=True), (2, 3, 64), True, ["K5", "K5"]),
             (trec.FreqLstm(64, 4, 256, 256), (2, 64, 4, 3), False, ["K1"]),
             (trec.FreqLstm(3, 4, 64, 100), (2, 3, 4, 3), False, ["K1"])]
    for mod, shape, training, want in cases:
        calls.clear()
        with torch.no_grad():
            mod.train(training)(torch.zeros(shape))
        assert calls == want


def test_plain_route_counts_card_tensors_outside_plain_versions():
    before = ops.PLAIN_ROUTES
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    ops.plain_route(torch.zeros(1))
    assert ops.PLAIN_ROUTES == before
    ops.plain_route(card)
    assert ops.PLAIN_ROUTES == before + 1
    with ops.plain_versions():
        ops.plain_route(card)
    assert ops.PLAIN_ROUTES == before + 1
    ops.PLAIN_ROUTES = before
