#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdfa_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py            # one to two minutes
    python3 chip_smoke.py --profile  # two to three. Also torch.profiler breakdowns: a request
                                     # (with its host-to-device copies counted), a server tick,
                                     # a train step; the biLSTM step kernel's SM clocks by part
                                     # of a step; the other tile choices of the training core,
                                     # of FreqLstm's step loop and of the solve product

Phases, each printed as one JSON line:

1. device: the card's name and power limit, torch / CUDA / nvcc versions.
2. build: compiles the five CUDA sources of ``sdfa_tpu_torch/csrc`` side by side
   and prints what ptxas says of each kernel (registers, shared memory, spills),
   how many clusters the card holds at once of the biLSTM step kernel, of
   FreqLstm's and of the training core's forward and backward kernels at each
   hidden width, how many blocks of the solve product, and the tensor-core
   opcodes (``HGMMA``) in the machine code of ``decode_solve``.
3. kernels: runs each kernel at its path's shapes, holds it against its plain
   PyTorch version on the same inputs, times both with CUDA events, computes
   the card's bound for the same work, and times the one library call that
   computes the same function where there is one (``torch.nn.LSTM`` through
   cuDNN for the recurrences), as a yardstick that no path uses. ``freq_lstm``
   and ``decode_solve`` are timed at a request's own shape as well (768 rows,
   216 windows). Every kernel is also held to its plain version, untimed, at
   ragged shapes that reach every edge of its tiling; ``freq_lstm``,
   ``decode_solve`` and ``bilstm_core``'s backward must give the same bits
   twice. One line times the solve's product as a single ``torch.matmul`` in
   TF32, for orientation: no path uses it.
4. serve: the flagship ``dgrad`` config at full width (seeded weights, seeded
   PCA bases at the shipped dims, a synthetic template with FLAME's 5023
   vertices / 9976 triangles / 1261 free vertices) serves three 3 s requests
   through ``AnimationTask.generate_vertices``; the launch counters of
   ``freq_lstm``, ``bilstm2`` and ``decode_solve`` must move.
5. check: one request again through the plain versions on the card, and
   sampled frames against the float64 host solve.
6. wires: the first request again on every wire (f32, i16, i8d, coef): error to
   the f32 wire (coef: to the float64 solve), bytes downloaded, wall time, the
   launch counters (``decode_solve`` must stay put on coef); an ensembled
   request against the mean of its two runs; a request with every kept
   constant dropped against the warm one, bit for bit.
7. session: one ``StreamingSession`` fed the clip in uneven chunks, then
   flushed, against the offline request.
8. server: ``StreamingServer(capacity=8)`` with 8 streams of different lengths
   and speakers on i16, i8d, coef and i16 pipelined, each stream against its
   own offline request; tick time, frames a second, bytes a frame. One run at
   capacity 32 for its tick time.
9. tcp: ``ServeApp`` + ``StreamServerTCP`` on 127.0.0.1, four ``StreamClient``
   threads, one of them on a coef service with a ``CoefDecoder``.
10. k4_path: the same config with a 1-layer time LSTM serves a 1 s request; the
   ``bilstm_layer`` counter must move and the plain versions must agree.
11. train: ``Trainer.train()`` takes 5 steps of 100 windows at full width with
   the shipped optimizer and loss sections; every loss term and the gradient
   norm must be finite, the ``bilstm_core`` forward and backward counters must
   each read 15, parameters must change, the checkpoint must load back equal,
   and one step through the plain versions from the same state and dropout
   seed must give the same loss and gradients.
12. data_train: ``synthetic.generate`` writes a dataset (2 speakers x 1
   sentence x 2 s at FLAME's counts, PCA bases fitted on it);
   ``api.train_model`` trains 30 steps on it in raw mode (the reader on a
   prefetch thread, the features made on the card), and the ``bilstm_core``
   counters must read 90 and 90, every epoch loss be finite and ``last.ckpt``
   exist; the median interval between step dispatches and the share of wall
   time the ``Trainer`` waited on its loader are printed. Then the device
   frontend on one training batch against the host features with the same
   knobs, 2 steps on host features, two ``PrefetchLoader`` batches from
   forkserver workers in this CUDA process, and the trained checkpoint served
   with the dataset's bases: a 3 s request against the float64 solve and the
   plain versions, the same request through the host frontend
   (``device_frontend=False``), and fault C4: K3 at the dataset's own
   projected coefficients (every frame of one sentence) against its plain
   version and the float64 decode + solve. The loader's forkserver and
   resource tracker are stopped before the phase ends.

Before its last lines the script checks that no process it started is left
(every process of its process group that was not there when it began). Any
failure raises, so the script exits non-zero and prints no result
line. The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
K1_ROWS = 4 * 768     # 4 clips x a 3 s clip's 768-frame grid
K1_REQUEST_ROWS = 768  # one 3 s request's frame grid
K2_WINDOWS = 256      # windows per suffix call
K3_WINDOWS = 256
K3_REQUEST_WINDOWS = 216  # one 3 s request's windows
K4_ROWS = 256
K1_LIVE_ROWS = (12, 128, 512)  # a stream's first block; a block round at capacity 8 and 32
LIVE_WINDOWS = (128, 512)      # a full tick's suffix call at capacity 8 and 32
TRAIN_WINDOWS = 100   # 50 adjacent-frame pairs, the shipped batch
TRAIN_STEPS = 5
DATA_TRAIN_STEPS = 30  # api.train_model from a generated dataset: 6 epochs of 5 batches
TOL = {"freq_lstm": 1e-4, "bilstm2": 1e-4, "decode_solve": 1e-5, "bilstm_layer": 1e-4,
       "bilstm_core_fwd": 1e-4}  # max |kernel - plain|
BWD_REL_TOL = 1e-4    # bilstm_core_bwd: max |diff| / max |reference|, for d(xp) and d(w_hh)
PLAIN_TOL_M = 1e-4    # wav -> vertices through kernels vs through plain versions
ORACLE_TOL_M = 1e-4   # sampled frames vs the float64 host solve
FRONTEND_TOL, FRONTEND_CH0_TOL = 2e-3, 5e-4  # device training frontend vs host features
WIRE_TOL_M = {"f32": 0.0, "i16": 5e-6 + 1e-7, "i8d": 2e-5 + 1e-7}  # a wire vs the f32 wire
COEF_ORACLE_TOL_M = 1e-6  # the coef wire, decoded on the host, vs the float64 host solve
STREAM_TOL_M = 1e-5   # streamed vs offline on the same audio (f32 and decoded coef frames)
SOCKET_TIMEOUT_S = 120.0
STEP_LOSS_RTOL = 1e-5  # train step, kernels vs plain versions: total loss
STEP_GRAD_RTOL = 1e-4  # ... and every gradient: max |diff| over the model's largest |gradient|;
                       # the recurrent layers' gradients also over their own largest |value|
F32_PEAK = 67e12      # H100 SXM, float32 outside the tensor cores, FLOP/s (data sheet)
TF32_PEAK = 495e12    # H100 SXM, TF32 on the tensor cores, dense, FLOP/s (data sheet)
HBM_RATE = 3.35e12    # H100 SXM, bytes/s (data sheet)


def emit(obj):
    print(json.dumps(obj), flush=True)


def group_processes():
    """pid -> (state, command line) of every other process in this script's
    process group, read from /proc."""
    group, me = os.getpgrp(), os.getpid()
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == me:
            continue
        try:
            with open(f"/proc/{entry}/stat") as fp:
                stat = fp.read()
            with open(f"/proc/{entry}/cmdline", "rb") as fp:
                cmd = fp.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # it exited while we looked
            continue
        state, _ppid, pgrp = stat[stat.rindex(")") + 2:].split()[:3]
        if int(pgrp) == group:
            found[int(entry)] = (state, cmd[:200])
    return found


def check_no_process_left(before):
    """Raises if a process that was not in the group when the script began
    is still there (running or unreaped)."""
    left = {pid: v for pid, v in group_processes().items() if pid not in before}
    emit({"phase": "processes_left", "count": len(left)})
    if left:
        raise RuntimeError(f"processes this script started are still there: {left}")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_backward_ms(make_out, inputs, dout, n: int) -> float:
    """Time of the backward pass alone: a fresh forward graph each turn, CUDA
    events around ``autograd.grad``; the first turn warms up."""
    import torch

    total = 0.0
    for turn in range(n + 1):
        out = make_out()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(out, inputs, dout)
        end.record()
        torch.cuda.synchronize()
        if turn:
            total += start.elapsed_time(end)
    return total / n


def bound(flops: float, nbytes: float, tensor_flops: float = 0.0):
    """The least time the card could take: the larger of operations over
    their unit's peak (``flops`` in float32 outside the tensor cores,
    ``tensor_flops`` in TF32 on them) and bytes (inputs once, outputs once)
    over the HBM rate."""
    t_ops = (flops / F32_PEAK + tensor_flops / TF32_PEAK) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tensor_core_sass(build) -> dict:
    """The tensor-core opcodes (``HGMMA``) in the machine code of the built
    ``decode_solve`` library, by ``cuobjdump -sass``: how many, and the first
    one. Raises if the product was compiled to none."""
    lib = build.load_library("decode_solve")._name
    sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True, timeout=120).stdout
    found = [line.split("*/")[1].split("/*")[0].strip(" ;") for line in sass.splitlines()
             if "GMMA" in line and "*/" in line]
    if not found:
        raise RuntimeError("decode_solve: no warpgroup matrix opcode in the machine code")
    return {"count": len(found), "first": found[0]}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def signal(seconds: float, sr: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110.0, 220.0)
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (sig + 0.02 * rng.standard_normal(len(t))).clip(-1, 1).astype(np.float32)


def train_batches(n: int):
    """Seeded synthetic batches at FLAME's counts, as the sliding-window
    reader ships them: first half frame i, second half frame i + 1."""
    import numpy as np

    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        half = rng.integers(0, 8, (TRAIN_WINDOWS // 2,)).astype(np.int64)
        out.append({
            "audio_feat": rng.normal(0.4, 0.2, (TRAIN_WINDOWS, 64, 128, 3)).astype(np.float32),
            "speaker_id": np.concatenate([half, half]),
            "dgrad_3d_scale_coef": rng.normal(0, 1, (TRAIN_WINDOWS, 1, 85)).astype(np.float32),
            "dgrad_3d_rotat_coef": rng.normal(0, 1, (TRAIN_WINDOWS, 1, 180)).astype(np.float32)})
    return out


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdfa_tpu_torch")):
        sys.exit("chip_smoke.py: the sdfa_tpu_torch package is not beside this script")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; this needs a GPU")
    processes_before = group_processes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import (bilstm2, bilstm_core, bilstm_layer, build, decode_solve,
                                    freq_lstm)
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import Experiment, Trainer, checkpoints
    from sdfa_tpu_torch.viewer import frame

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    build.load_libraries(["freq_lstm", "bilstm2", "decode_solve", "bilstm_layer", "bilstm_core"])
    core_clusters = {f"{hid}_{which}": n  # resident clusters per (hidden width, pass)
                     for (hid, which), n in bilstm_core.max_active_clusters(dev).items()}
    k1_clusters = freq_lstm.max_active_clusters(dev)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {k: v["seconds"] for k, v in build.BUILD_INFO.items()},
          "bilstm_step_kernel_max_active_clusters": bilstm_layer.max_active_clusters(dev),
          "bilstm_core_max_active_clusters": core_clusters,
          "freq_lstm_step_kernel_max_active_clusters": k1_clusters,
          "decode_solve_product_resident_blocks": decode_solve.resident_blocks(dev),
          "decode_solve_tensor_core_sass": tensor_core_sass(build),
          "ptxas": {k: v["ptxas"] for k, v in build.BUILD_INFO.items()}})

    # --- the flagship model at full width, seeded ---------------------------
    hp = configure("dgrad")
    rng = np.random.default_rng(SEED)
    n_tris = FLAME_COUNTS[1]
    pca = {"scale_compT": rng.normal(0, 0.01, (6 * n_tris, 85)).astype(np.float32),
           "scale_means": rng.normal(0, 0.01, (6 * n_tris,)).astype(np.float32),
           "rotat_compT": rng.normal(0, 0.01, (3 * n_tris, 180)).astype(np.float32),
           "rotat_means": rng.normal(0, 0.01, (3 * n_tris,)).astype(np.float32)}
    model = init_params(build_model(hp, pca=pca), SEED)
    t0 = time.perf_counter()
    verts, faces, cnst = synthetic_template(SEED)
    solver = frame.set_template_mesh(verts, faces, cnst)
    assert (solver.n_verts, solver.n_tris, solver.n_free) == FLAME_COUNTS
    task = AnimationTask(hp, model, dev)
    _, consts, dsc = task._decode_consts()
    emit({"phase": "setup", "solver_and_consts_s": time.perf_counter() - t0,
          "n_verts": solver.n_verts, "n_tris": solver.n_tris, "n_free": solver.n_free,
          "params": sum(p.numel() for p in model.parameters())})

    # --- each kernel against its plain version at its path's shapes ---------
    def randn(seed, *shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))).to(dev)

    def library_lstm(n_in, hidden, layers, seed):
        lstm = torch.nn.LSTM(n_in, hidden, num_layers=layers, bias=False, bidirectional=True)
        torch.manual_seed(seed)
        for p in lstm.parameters():
            torch.nn.init.uniform_(p, -hidden ** -0.5, hidden ** -0.5)
        return lstm.to(dev)

    report = {}

    def record(name, shape, err, tol, ms, plain_ms, flops, moved, library_ms, source, replaces,
               primary=True, tensor_flops=0.0, **extra):
        bound_ms, bound_by = bound(flops, moved, tensor_flops)
        line = {"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err, "tol": tol,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "gflop": flops / 1e9, "mbytes": moved / 1e6,
                "card": smi, **extra}
        if tensor_flops:
            line["gflop_tf32_tensor_cores"] = tensor_flops / 1e9
        emit(line)
        if not err <= tol:
            raise RuntimeError(f"{name} {shape}: kernel disagrees with its plain version: "
                               f"{err} > {tol}")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                 **{k: v for k, v in extra.items() if k in ("err_is", "bound_peaks")}}
        if primary:
            report[name] = entry
        else:
            report[name].setdefault("other_shapes", []).append(
                {k: entry[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")})

    def forward_case(name, kernel, plain, args, flops, library, source, replaces, primary=True):
        with torch.inference_mode():
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{name}: non-finite output")
            err = float((got - want).abs().max())
            ms = time_ms(lambda: kernel(*args), 5)
            plain_ms = time_ms(lambda: plain(*args), 3)
            library_ms = time_ms(library, 5) if library else None
        moved = nbytes(*[a for a in args if torch.is_tensor(a)], got)
        record(name, list(args[0].shape), err, TOL[name], ms, plain_ms, flops, moved, library_ms,
               source, replaces, primary)

    def repeats(name, kernel, args, first):
        """Two launches on the same inputs must be equal bit for bit."""
        if not torch.equal(kernel(*args), first):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: two launches on the same inputs "
                               "differ")
        return True

    enc = model.audio_encoder
    fl = enc.built_layers_6
    w_ih, w_hh, gb = fl.lstm.layer_weights(0)
    k1_weights = (w_ih, w_hh, gb, fl.proj.weight(), fl.proj.bias)
    lib1 = library_lstm(64, 128, 1, 1)
    # the kernel phase's four clips, one request's grid, then live serving's block rounds
    for rows in (K1_ROWS, K1_REQUEST_ROWS) + K1_LIVE_ROWS:
        x1 = randn(1, rows, fl.freq_length, w_ih.shape[1])
        x1_lib = x1.transpose(0, 1).contiguous()
        forward_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain,
                     (x1, *k1_weights), 2.0 * rows * (32 * 2 * (64 + 128) * 512 + 8192 * 256),
                     lambda: lib1(x1_lib),  # the LSTM part only: no 8192 -> 256 projection
                     "sdfa_tpu_torch/csrc/freq_lstm.cu", "sdfa_tpu/ops/pallas_freq_lstm.py:187",
                     primary=rows == K1_ROWS)
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, (x1, *k1_weights),
                    freq_lstm.freq_lstm(x1, *k1_weights))

    lw = [enc.built_layers_9.layer_weights(layer) for layer in range(2)]
    lib2 = library_lstm(256, 256, 2, 2)
    for windows in (K2_WINDOWS,) + LIVE_WINDOWS:  # then a live tick's suffix calls
        x2 = randn(2, windows, 64, 256, scale=0.5)
        x2_lib = x2.transpose(0, 1).contiguous()
        forward_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain, (x2, *lw[0], *lw[1]),
                     2.0 * windows * 64 * 2 * ((256 + 256) + (512 + 256)) * 1024,
                     lambda: lib2(x2_lib), "sdfa_tpu_torch/csrc/bilstm2.cu",
                     "sdfa_tpu/ops/pallas_bilstm2.py:52", primary=windows == K2_WINDOWS)

    # K3 at the kernel phase's 256 windows, a request's 216, a live tick's 128 and 512; its
    # bound reckons the decode
    # in float32 outside the tensor cores and the solve's product in TF32 on them. Then, held
    # to the plain version only: one window, 7, 43, and one more than 256. Every case is
    # launched twice: the K parts are added in a fixed order, so the bits must repeat.
    tp, nf = dsc.p.shape[1:]
    k3_src = ("sdfa_tpu_torch/csrc/decode_solve.cu", "sdfa_tpu/ops/pallas_decode_solve.py:229")
    k3_timed = (K3_WINDOWS, K3_REQUEST_WINDOWS) + LIVE_WINDOWS
    for windows in k3_timed + (1, 7, 43, K3_WINDOWS + 1):
        g3 = torch.Generator().manual_seed(3 if windows == K3_WINDOWS else 300 + windows)
        coef_s = torch.randn(windows, 85, generator=g3).to(dev)
        coef_r = torch.randn(windows, 180, generator=g3).to(dev)
        timed = windows in k3_timed
        with torch.inference_mode():
            got = decode_solve.decode_solve(coef_s, coef_r, dsc)
            torch.cuda.synchronize()
            want = decode_solve.decode_solve_plain(coef_s, coef_r, dsc)
            err = float((got - want).abs().max())
            twice = repeats("decode_solve", decode_solve.decode_solve, (coef_s, coef_r, dsc), got)
            if not timed:
                emit({"phase": "kernel", "name": "decode_solve", "shape": list(got.shape),
                      "max_abs_err": err, "tol": TOL["decode_solve"],
                      "repeats_bit_for_bit": twice, "card": smi})
                if not (err <= TOL["decode_solve"] and bool(torch.isfinite(got).all())):
                    raise RuntimeError(f"decode_solve {windows} windows: {err}")
                continue
            ms = time_ms(lambda: decode_solve.decode_solve(coef_s, coef_r, dsc), 5)
            plain_ms = time_ms(lambda: decode_solve.decode_solve_plain(coef_s, coef_r, dsc), 5)
            # for orientation only, used by no path: the solve's product (3W x 3T') . (3T' x NF)
            # as one library call in TF32
            dt = decode_solve.delta_transforms(coef_s, coef_r, dsc).reshape(3 * windows, 3 * tp)
            p_mat = dsc.p.reshape(3 * tp, nf)
            try:
                torch.backends.cuda.matmul.allow_tf32 = True
                matmul_tf32_ms = time_ms(lambda: dt @ p_mat, 5)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            matmul_f32_ms = time_ms(lambda: dt @ p_mat, 5)
            del dt
        emit({"phase": "yardstick", "what": "the solve's product alone as one torch.matmul",
              "shape": [3 * windows, 3 * tp, nf], "tf32_ms": matmul_tf32_ms,
              "f32_ms": matmul_f32_ms, "card": smi})
        record("decode_solve", list(got.shape), err, TOL["decode_solve"], ms, plain_ms,
               2.0 * windows * (85 * 6 + 180 * 3) * tp,
               nbytes(coef_s, coef_r, *dsc, got) - nbytes(dsc.p),  # the kernel reads p_t, not p
               None,  # no one call computes decode + solve
               *k3_src, primary=windows == K3_WINDOWS, tensor_flops=2.0 * windows * 9 * tp * nf,
               bound_peaks="decode: 67 TFLOP/s f32; product: 495 TFLOP/s TF32 tensor cores",
               repeats_bit_for_bit=twice)

    for n_in, layer in ((256, 0), (512, 1)):  # the stack's first layer, then a deeper one
        x4 = randn(4 + layer, K4_ROWS, 64, n_in, scale=0.5)
        lib4, x4_lib = library_lstm(n_in, 256, 1, 4 + layer), x4.transpose(0, 1).contiguous()
        forward_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                     (x4, *lw[layer]), 2.0 * K4_ROWS * 64 * 2 * (n_in + 256) * 1024,
                     lambda: lib4(x4_lib), "sdfa_tpu_torch/csrc/bilstm_layer.cu",
                     "sdfa_tpu/ops/pallas_bilstm.py:42", primary=layer == 0)

    # K4 and K2 at ragged shapes, held to the plain versions only: one row, a partial row
    # tile, the request's 216 windows, a second row chunk (257 rows at T = 64); T = 1 and 3;
    # an input width that is no multiple of the projection's K tile; with and without bias
    def ragged_case(name, kernel, plain, args):
        with torch.inference_mode():
            got = kernel(*args)
            torch.cuda.synchronize()
            err = float((got - plain(*args)).abs().max())
        emit({"phase": "kernel", "name": name, "shape": list(args[0].shape),
              "gate_bias": args[3] is not None, "max_abs_err": err, "tol": TOL[name],
              "card": smi})
        if not (err <= TOL[name] and bool(torch.isfinite(got).all())):
            raise RuntimeError(f"{name} {tuple(args[0].shape)}: {err} > {TOL[name]}")

    def layer_weights(seed, n_in, bias):
        return (randn(seed, 2, n_in, 1024, scale=1 / 16),
                randn(seed + 1, 2, 256, 1024, scale=1 / 16),
                randn(seed + 2, 2, 1024, scale=0.1) if bias else None)

    for i, (rows, steps, n_in, bias) in enumerate((
            (1, 1, 100, True), (7, 3, 256, False), (216, 64, 512, True), (257, 64, 100, False),
            (257, 3, 512, True), (1, 64, 256, False), (7, 1, 512, True), (216, 3, 100, False))):
        first = (randn(60 + 10 * i, rows, steps, n_in, scale=0.5),
                 *layer_weights(61 + 10 * i, n_in, bias))
        ragged_case("bilstm_layer", bilstm_layer.bilstm_layer, bilstm_layer.bilstm_layer_plain,
                    first)
        ragged_case("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain,
                    first + layer_weights(64 + 10 * i, 512, bias))

    # K1 at ragged shapes, held to the plain version only and launched twice (the slabs of the
    # output projection are added in a fixed order): one row; a partial row tile; one row more
    # than a tile; one row more than a wave of resident clusters, which is also a second row
    # chunk at F = 32; F = 1 and F = 3; an input width that is no multiple of 4; with and
    # without gate bias and b_proj
    wave_rows = k1_clusters // 2 * freq_lstm.ROW_TILE
    for i, (rows, n_freq, n_in, bias) in enumerate((
            (1, 32, 64, True), (7, 3, 64, False), (freq_lstm.ROW_TILE + 1, 32, 100, True),
            (wave_rows + 1, 32, 64, False), (216, 1, 64, True), (257, 3, 100, False),
            (wave_rows + 1, 1, 100, True))):
        args = (randn(160 + 10 * i, rows, n_freq, n_in),
                randn(161 + 10 * i, 2, n_in, 512, scale=n_in ** -0.5),
                randn(162 + 10 * i, 2, 128, 512, scale=128 ** -0.5),
                randn(163 + 10 * i, 2, 512, scale=0.1) if bias else None,
                randn(164 + 10 * i, n_freq * 256, 256, scale=0.02),
                randn(165 + 10 * i, 256, scale=0.1) if bias else None)
        ragged_case("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain, args)
        with torch.inference_mode():
            repeats("freq_lstm", freq_lstm.freq_lstm, args, freq_lstm.freq_lstm(*args))

    # K5 at the train step's two shapes (the FreqLstm core first: it is the larger), then,
    # held to the plain version only, ragged shapes that reach every edge of the cluster
    # tiling at both widths: one row; a partial row tile with T = 2 (the double buffers'
    # first turn); T = 1 (no exchange at all) at one row more than a tile; one row more than
    # one wave of resident clusters; T = 64 at 100 rows. Every case also launches the
    # backward twice on the same inputs: the partial sums are added in a fixed order, so
    # the two results must be equal bit for bit.
    core_src = "sdfa_tpu_torch/csrc/bilstm_core.cu"
    cases = [(32, 6400, 128, 64), (64, 100, 256, 256), (3, 1061, 256, 0), (5, 7, 128, 0)]
    for hid, tile in bilstm_core.ROW_TILE.items():
        wave_tiles = min(core_clusters[f"{hid}_fwd"], core_clusters[f"{hid}_bwd"]) // 2
        cases += [(3, 1, hid, 0), (2, 7, hid, 0), (1, tile + 1, hid, 0),
                  (3, wave_tiles * tile + 1, hid, 0)]
    cases.append((64, 100, 128, 0))  # at H = 256 this is a timed shape already

    def core_case(steps, rows, hid, n_in):  # a function: its tensors go when it returns
        timed = n_in > 0
        xp = randn(50 + hid, 2, steps, rows, 4 * hid, scale=0.5).requires_grad_()
        w_core = randn(51 + hid, 2, hid, 4 * hid, scale=hid ** -0.5).requires_grad_()
        dout = randn(52 + hid, steps, rows, 2 * hid)
        out = bilstm_core.bilstm_core(xp, w_core)
        torch.cuda.synchronize()
        got_g = torch.autograd.grad(out, (xp, w_core), dout)
        torch.cuda.synchronize()
        ref = bilstm_core.bilstm_core_plain(xp, w_core)
        ref_g = torch.autograd.grad(ref, (xp, w_core), dout)
        err_f = float((out - ref).detach().abs().max())
        err_b = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(got_g, ref_g))
        xp_d, w_d = xp.detach(), w_core.detach()
        with torch.no_grad():
            _, gates, cs = bilstm_core._forward_kernel(xp_d, w_d)
            again = bilstm_core._backward_kernel(gates, cs, w_d, dout)
            repeats = (torch.equal(again, got_g[0]) and
                       torch.equal(again, bilstm_core._backward_kernel(gates, cs, w_d, dout)))
        if not repeats:
            raise RuntimeError(f"bilstm_core backward {(steps, rows, hid)}: two launches on the "
                               "same inputs differ")
        if not timed:
            emit({"phase": "kernel", "name": "bilstm_core", "shape": [steps, rows, hid],
                  "fwd_max_abs_err": err_f, "bwd_max_rel_err": err_b,
                  "bwd_repeats_bit_for_bit": repeats, "card": smi})
            if not (err_f <= TOL["bilstm_core_fwd"] and err_b <= BWD_REL_TOL):
                raise RuntimeError(f"bilstm_core {(steps, rows, hid)}: {err_f}, {err_b}")
            return
        del ref, ref_g, got_g, again
        lib5 = library_lstm(n_in, hid, 1, 5).train()
        x5 = randn(53, steps, rows, n_in, scale=0.5).requires_grad_()
        with torch.no_grad():
            fwd_ms = time_ms(lambda: bilstm_core.bilstm_core(xp_d, w_d), 5)
            plain_fwd_ms = time_ms(lambda: bilstm_core.bilstm_core_plain(xp_d, w_d), 3)
            bwd_ms = time_ms(lambda: bilstm_core._backward_kernel(gates, cs, w_d, dout), 5)
            dw_ms = time_ms(lambda: bilstm_core.dw_hh(out.detach(), gates), 5)
        lib_fwd_ms = time_ms(lambda: lib5(x5), 5)
        plain_bwd_ms = time_backward_ms(lambda: bilstm_core.bilstm_core_plain(xp, w_core),
                                        (xp, w_core), dout, 2)
        lib_bwd_ms = time_backward_ms(lambda: lib5(x5)[0], (x5, *lib5.parameters()), dout, 3)
        flops = 2.0 * steps * rows * 2 * hid * 4 * hid
        primary = hid == 128
        record("bilstm_core_fwd", [steps, rows, hid], err_f, TOL["bilstm_core_fwd"], fwd_ms,
               plain_fwd_ms, flops, nbytes(xp, w_core, out, gates, cs), lib_fwd_ms, core_src,
               "sdfa_tpu/ops/pallas_bilstm_train.py:101", primary)
        record("bilstm_core_bwd", [steps, rows, hid], err_b, BWD_REL_TOL, bwd_ms, plain_bwd_ms,
               flops, nbytes(gates, cs, w_core, dout, xp), lib_bwd_ms, core_src,
               "sdfa_tpu/ops/pallas_bilstm_train.py:198", primary,
               err_is="max |diff| / max |reference| over d(xp) and d(w_hh)",
               dw_hh_library_product_ms=dw_ms, repeats_bit_for_bit=repeats)

    for case in cases:
        core_case(*case)
    torch.cuda.empty_cache()

    # --- the serving path: warm up, then three requests --------------------
    sr = int(hp.audio.sample_rate)
    warm_s = task.warmup(3.0)
    requests = [(signal(3.0, sr, 10 + i), spk) for i, spk in enumerate((0, 3, 6))]
    for mod in (freq_lstm, bilstm2, decode_solve):
        mod.LAUNCHES = 0
    outs, walls = [], []
    for sig, spk in requests:
        t0 = time.perf_counter()
        ts, v = task.generate_vertices(sig, spk)
        walls.append(time.perf_counter() - t0)
        outs.append((ts, v))
    launches = {"freq_lstm": freq_lstm.LAUNCHES, "bilstm2": bilstm2.LAUNCHES,
                "decode_solve": decode_solve.LAUNCHES}
    for (ts, v), (sig, _) in zip(outs, requests):
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"bad output: shape {v.shape}, finite {np.isfinite(v).all()}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    emit({"phase": "serve", "requests": len(requests), "audio_s_each": 3.0,
          "windows": [len(ts) for ts, _ in outs], "warmup_s": warm_s, "wall_s": walls,
          "audio_s_per_s": [3.0 / w for w in walls], "launches": launches, "card": smi})

    # --- the same request through the plain versions, and the f64 oracle ----
    (ts0, v0), (sig0, spk0) = outs[0], requests[0]
    with ops.plain_versions():
        _, v_plain = task.generate_vertices(sig0, spk0)
    plain_err = float(np.abs(v_plain - v0).max())
    sample = sorted({0, len(ts0) // 3, 2 * len(ts0) // 3, len(ts0) - 1})
    with torch.inference_mode():
        frame_idx, _, z, _ = task._overlap_prefix(sig0)
        idx = torch.from_numpy(frame_idx[sample]).long().to(dev)
        spk = torch.full((len(sample),), spk0, dtype=torch.long, device=dev)
        preds, _, _ = model.forward_windows(z, idx, spk, raw_pca=True)
        dgrad = model.decode_to_anime(preds)[:, 0].double().cpu().numpy()
    oracle = np.stack([solver.solve_host(d) for d in dgrad])
    oracle_err = float(np.abs(v0[sample] - oracle).max())
    emit({"phase": "check", "plain_max_abs_m": plain_err, "plain_tol_m": PLAIN_TOL_M,
          "oracle_frames": sample, "oracle_max_abs_m": oracle_err,
          "oracle_tol_m": ORACLE_TOL_M,
          "vertex_range_m": [float(v0.min()), float(v0.max())]})
    if not plain_err <= PLAIN_TOL_M:
        raise RuntimeError(f"kernel path vs plain path: {plain_err} m > {PLAIN_TOL_M}")
    if not oracle_err <= ORACLE_TOL_M:
        raise RuntimeError(f"kernel path vs float64 oracle: {oracle_err} m > {ORACLE_TOL_M}")

    # --- live serving: every wire, ensembling, a session, the server, the TCP service ---
    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    path_launches = {"serve": dict(launches)}
    path_launches["wires"] = wires_phase(task, counters, sig0, spk0, v0, sample, oracle, smi)
    path_launches["session"] = session_phase(task, counters, sig0, spk0, ts0, v0, smi)
    path_launches["server"] = server_phase(task, counters, sr, smi)
    path_launches["tcp"] = tcp_phase(task, counters, sr, smi)

    if "--profile" in sys.argv[1:]:
        profile_serving(task, requests, sorted(walls)[1] * 1e3, smi)
        profile_server_tick(task, sr, smi)
        profile_step_clocks(build, dev, smi)
        profile_core_tiles(build, dev, smi)
        profile_serving_tiles(build, dev, smi, k1_weights, dsc)

    # --- K4's path: a stack that is not 2 layers deep serves through bilstm_layer ---
    hp1 = configure("dgrad")
    hp1.model.audio_encoder.set_key("layers", [
        ("lstm", 256, 256, "num_layers=1", "bidirectional=True") if spec[0] == "lstm"
        else spec for spec in hp1.model.audio_encoder.layers])
    task1 = AnimationTask(hp1, init_params(build_model(hp1, pca=pca), SEED), dev)
    task1._decode = task._decode  # same template, same PCA bases
    sig1 = signal(1.0, sr, 20)
    task1.generate_vertices(sig1, 2)  # warm-up
    bilstm_layer.LAUNCHES = 0
    t0 = time.perf_counter()
    ts1, v1 = task1.generate_vertices(sig1, 2)
    wall1 = time.perf_counter() - t0
    launches["bilstm_layer"] = bilstm_layer.LAUNCHES
    path_launches["k4_path"] = {"bilstm_layer": launches["bilstm_layer"]}
    with ops.plain_versions():
        _, v1_plain = task1.generate_vertices(sig1, 2)
    k4_err = float(np.abs(v1 - v1_plain).max())
    emit({"phase": "k4_path", "audio_s": 1.0, "windows": len(ts1), "wall_s": wall1,
          "launches": launches["bilstm_layer"], "plain_max_abs_m": k4_err,
          "plain_tol_m": PLAIN_TOL_M, "card": smi})
    if launches["bilstm_layer"] < 1:
        raise RuntimeError("the 1-layer stack did not launch bilstm_layer")
    if v1.shape != (len(ts1), FLAME_COUNTS[0], 3) or not np.isfinite(v1).all():
        raise RuntimeError(f"k4 path: bad output {v1.shape}")
    if not k4_err <= PLAIN_TOL_M:
        raise RuntimeError(f"k4 path, kernels vs plain versions: {k4_err} m > {PLAIN_TOL_M}")
    del task1

    # --- the training path: Trainer.train() for 5 steps at full width ----------
    hp_t = configure("dgrad")
    hp_t.trainer.set_key("max_epochs", 1)
    hp_t.trainer.set_key("save_gap_epochs", 1)
    batches = train_batches(TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="sdfa_chip_smoke_") as tmp:
        def experiment(name, **kw):
            return Experiment(hp_t, build_model(hp_t, pca=pca), os.path.join(tmp, name), dev,
                              seed=SEED, **kw)

        # one step on a throwaway experiment warms up the allocator and the libraries,
        # and is the kernel side of the kernel-vs-plain comparison below
        warm = experiment("warm")
        m_kernel = warm.train_step(batches[0])
        g_kernel = {n: p.grad.clone() for n, p in warm.model.named_parameters()}
        torch.cuda.synchronize()
        del warm

        exp = experiment("run")
        before = {k: v.clone() for k, v in exp.model.state_dict().items()}
        stamps = []

        def timed_loader():
            # the Trainer asks for the next batch between steps: a synchronize there
            # brackets each step, upload and host work included
            for batch in batches:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield batch
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(exp, timed_loader())
        trainer.train()
        launches["bilstm_core_fwd"] = bilstm_core.FWD_LAUNCHES
        launches["bilstm_core_bwd"] = bilstm_core.BWD_LAUNCHES
        path_launches["train"] = {k: launches[k] for k in ("bilstm_core_fwd", "bilstm_core_bwd")}
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
        for i, m in enumerate(trainer.step_metrics):
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if bad:
                raise RuntimeError(f"train step {i}: non-finite {bad}")
        if (launches["bilstm_core_fwd"], launches["bilstm_core_bwd"]) != (3 * TRAIN_STEPS,) * 2:
            raise RuntimeError(f"bilstm_core launches {launches}, expected {3 * TRAIN_STEPS} each")
        after = exp.model.state_dict()
        unchanged = [n for n, p in exp.model.named_parameters() if torch.equal(before[n], p)]
        if unchanged:
            raise RuntimeError(f"parameters did not change: {unchanged}")
        loaded = experiment("reload", load_from=checkpoints.latest_checkpoint(exp.log_dir))
        got_state, got_opt = loaded.model.state_dict(), loaded.optimizer.state_dict()["state"]
        same = (all(torch.equal(got_state[k], v) for k, v in after.items())
                and all(torch.equal(got_opt[i][k], v)
                        for i, slot in exp.optimizer.state_dict()["state"].items()
                        for k, v in slot.items())
                and all(torch.equal(a, b) for n in exp.scalers
                        for a, b in zip(loaded.scalers[n], exp.scalers[n]))
                and (loaded.step, loaded.epoch) == (exp.step, exp.epoch) == (TRAIN_STEPS, 1))
        if not same:
            raise RuntimeError("the reloaded checkpoint differs from the state saved")
        del loaded

        plain = experiment("plain")
        with ops.plain_versions():
            m_plain = plain.train_step(batches[0])
        loss_rel = abs(float(m_kernel["total"]) - float(m_plain["total"])) / abs(
            float(m_plain["total"]))
        # A gradient that is zero but for rounding (the weight-norm gain of a conv whose
        # output goes through BatchNorm, the attention query under a near-uniform softmax)
        # differs by 1e-3 of its own size between two runs of the SAME path, so every
        # parameter is held to the largest gradient of the model, and the recurrent
        # layers' own parameters, which the kernels produce, to their own size as well.
        def own_size_diffs(grads):
            """max |kernel − other| per parameter, and the same over its own max |value|."""
            diffs = {n: float((g_kernel[n] - g).abs().max()) for n, g in grads.items()}
            return diffs, {n: diffs[n] / max(float(g.abs().max()), 1e-30)
                           for n, g in grads.items()}

        g_plain = {n: p.grad for n, p in plain.model.named_parameters()}
        g_max = max(float(g.abs().max()) for g in g_plain.values())
        diffs, own = own_size_diffs(g_plain)
        grad_rel = max(diffs.values()) / g_max
        lstm_rel = max(v for n, v in own.items()
                       if n.rpartition(".")[2].startswith(("w_ih", "w_hh", "b_ih", "b_hh")))
        worst = sorted(own, key=own.get, reverse=True)[:3]
        del plain
        again = experiment("again")  # the kernel path once more: the floor of that measure
        again.train_step(batches[0])
        _, own_again = own_size_diffs({n: p.grad for n, p in again.model.named_parameters()})
        worst_again = max(own_again, key=own_again.get)
        del again
        emit({"phase": "train", "steps": TRAIN_STEPS, "windows_per_step": TRAIN_WINDOWS,
              "step_ms_median": step_ms[len(step_ms) // 2], "step_ms_all": step_ms,
              "windows_per_s": TRAIN_WINDOWS / (step_ms[len(step_ms) // 2] / 1e3),
              "peak_memory_gib": peak_gib, "launches": {k: launches[k] for k in (
                  "bilstm_core_fwd", "bilstm_core_bwd")},
              "first_step": trainer.step_metrics[0], "last_step": trainer.step_metrics[-1],
              "plain_step_loss_rel": loss_rel, "plain_step_grad_vs_largest_gradient": grad_rel,
              "plain_step_lstm_grad_rel": lstm_rel, "largest_gradient": g_max,
              "worst_by_own_size": [{"name": n, "rel": own[n],
                                     "max_abs_gradient": float(g_plain[n].abs().max())}
                                    for n in worst],
              "same_path_twice_worst_by_own_size": {"name": worst_again,
                                                    "rel": own_again[worst_again]},
              "loss_rtol": STEP_LOSS_RTOL, "grad_rtol": STEP_GRAD_RTOL, "card": smi})
        if not loss_rel <= STEP_LOSS_RTOL:
            raise RuntimeError(f"train step, kernels vs plain: loss differs by {loss_rel}")
        if not (grad_rel <= STEP_GRAD_RTOL and lstm_rel <= STEP_GRAD_RTOL):
            raise RuntimeError(f"train step, kernels vs plain: gradients differ by {grad_rel} "
                               f"of the largest gradient, {lstm_rel} on the recurrent layers")

        if "--profile" in sys.argv[1:]:
            profile_train_step(exp, batches, smi, step_ms[len(step_ms) // 2])

    # --- training from a dataset on disk, then its checkpoint served -----------
    path_launches["data_train"] = data_train_phase(task, sig0, spk0, solver, dev, smi)
    check_no_process_left(processes_before)

    kernels = []
    for name, entry in report.items():
        entry["launches"] = launches[name]
        if entry["launches"] < 1:
            raise RuntimeError(f"{name} was never launched on its path")
        entry["launches_by_path"] = {path: counts[name] for path, counts in path_launches.items()
                                     if name in counts}
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def data_train_phase(task_seeded, sig, spk, solver, dev, smi):
    """``synthetic.generate`` → ``api.train_model`` (raw mode, thread prefetch,
    30 steps) → the device frontend against the host features on one batch →
    2 steps on host features and two ``PrefetchLoader`` batches from forkserver
    workers → the trained checkpoint served with the dataset's fitted PCA bases
    → K3 at the dataset's own coefficients (fault C4). Returns the launch
    counts of the phase's own path (the comparisons after it not counted)."""
    from sdfa_tpu_torch.ops import bilstm2, decode_solve, freq_lstm

    from sdfa_tpu_torch.data import prefetch

    counters = {"freq_lstm": freq_lstm, "bilstm2": bilstm2, "decode_solve": decode_solve}
    out = {"phase": "data_train", "card": smi}
    try:
        return _data_train(out, task_seeded, sig, spk, solver, dev, counters)
    finally:
        # the loader's forkserver and resource tracker would only exit after this
        # process; stop them now, and wait for them
        prefetch.stop_servers()
        emit(out)  # what was measured, also when a check failed


def _data_train(out, task_seeded, sig, spk, solver, dev, counters):
    import csv

    import numpy as np
    import torch

    from sdfa_tpu_torch import api, ops
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.data import DatasetSlidingWindow, synthetic
    from sdfa_tpu_torch.data import device_features as dfeat
    from sdfa_tpu_torch.data.prefetch import PrefetchLoader
    from sdfa_tpu_torch.mesh import FLAME_COUNTS
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm_core, decode_solve
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.train import checkpoints
    from sdfa_tpu_torch.train.trainer import RAW_KEYS

    with tempfile.TemporaryDirectory(prefix="sdfa_chip_data_") as tmp:
        t0 = time.perf_counter()
        root = synthetic.generate(os.path.join(tmp, "voca"), "dgrad_3d", speakers=["m0", "f0"],
                                  sentences_per_speaker=1, seconds_per_sentence=2.0, seed=SEED)
        pca_on = {"trainer": {"pca_targets": True}}
        hp = configure("dgrad", dataset_root=root, overrides=pca_on)
        out["generate_s"] = time.perf_counter() - t0
        out["train_windows"] = len(DatasetSlidingWindow(hp, training=True))

        # 1. api.train_model: raw mode, thread prefetch, 30 steps; training launches
        #    bilstm_core only (no validation pass runs K1 / K2, no request K3)
        bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
        reset_counts(counters)
        run = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        exp = api.train_model("dgrad", dataset_root=root, log_dir=run, max_steps=DATA_TRAIN_STEPS,
                              overrides=pca_on, device=dev)
        out["train_model_s"] = time.perf_counter() - t0
        path = read_counts(counters, "data_train train_model", zero=tuple(counters))
        core = (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)
        out["bilstm_core_launches"] = list(core)
        if core != (3 * DATA_TRAIN_STEPS,) * 2 or exp.step != DATA_TRAIN_STEPS:
            raise RuntimeError(f"train_model: {exp.step} steps, bilstm_core launches {core}")
        ckpt = os.path.join(run, "last.ckpt")
        if not os.path.exists(ckpt):
            raise RuntimeError("train_model wrote no last.ckpt")
        with open(os.path.join(run, "train_log", "loss", "epoch-loss.csv"), newline="") as fp:
            rows = list(csv.DictReader(fp))
        bad = [(r["epoch"], k) for r in rows for k, v in r.items()
               if k != "epoch" and not np.isfinite(float(v))]
        if bad or not rows:
            raise RuntimeError(f"train_model: non-finite epoch losses {bad} ({len(rows)} rows)")
        timing = [json.loads(line) for line in open(os.path.join(run, "train_log",
                                                                  "metrics.jsonl"))]
        timing = [t for t in timing if t["tag"] == "timing"]
        out.update(epochs=len(rows), first_epoch_loss=float(rows[0]["train_total"]),
                   last_epoch_loss=float(rows[-1]["train_total"]),
                   step_interval_median_ms_by_epoch=[1e3 * t["step_interval_median_s"]
                                                     for t in timing],
                   step_interval_median_ms=1e3 * float(np.median(
                       [t["step_interval_median_s"] for t in timing])),
                   loader_wait_share=sum(t["loader_wait_s"] for t in timing)
                   / sum(t["wall_s"] for t in timing))

        # 2. the device frontend on one training batch against the host features
        ds = DatasetSlidingWindow(hp, training=True)
        batch = next(ds.raw_batches(int(hp.trainer.anime_loader.batch_size)))
        with torch.no_grad():
            got = dfeat.device_train_features(
                *(torch.from_numpy(batch[k]).to(dev) for k in RAW_KEYS),
                spec=dfeat.FeatureSpec.from_hparams(hp)).cpu().numpy()
        want = np.stack([dfeat.host_train_features(
            *(batch[k][i] for k in RAW_KEYS[:7]), mel_cfg=ds._mel_cfg, sr=ds._sr)
            for i in range(len(got))])
        out["frontend"] = {"windows": len(got), "max_abs": float(np.abs(got - want).max()),
                           "channel0_max_abs": float(np.abs(got[..., 0] - want[..., 0]).max()),
                           "tol": FRONTEND_TOL, "channel0_tol": FRONTEND_CH0_TOL}
        if not (out["frontend"]["max_abs"] <= FRONTEND_TOL
                and out["frontend"]["channel0_max_abs"] <= FRONTEND_CH0_TOL):
            raise RuntimeError(f"device frontend vs host features: {out['frontend']}")

        # 3. host features: two steps, then two batches from forkserver workers
        t0 = time.perf_counter()
        host_exp = api.train_model("dgrad", dataset_root=root, log_dir=os.path.join(tmp, "host"),
                                   max_steps=2, device=dev,
                                   overrides={"trainer": {"pca_targets": True,
                                                          "host_features": True}})
        out["host_features_train_s"] = time.perf_counter() - t0
        if host_exp.step != 2:
            raise RuntimeError(f"host-feature training took {host_exp.step} steps, not 2")
        want = ds.collate([ds[0], ds[1]])
        schema = {k: (v.shape[1:], v.dtype) for k, v in want.items()}
        loader = PrefetchLoader(ds, 4, num_workers=2)
        got = []
        t0 = time.perf_counter()
        for b in loader:
            got.append(b)
            if len(got) == 2:
                break
        out["prefetch_two_batches_s"] = time.perf_counter() - t0
        loader.close()  # the loop broke out of the epoch: stop its workers now
        for b in got:
            if ({k: (v.shape[1:], v.dtype) for k, v in b.items()} != schema
                    or len(b["audio_feat"]) != 8):
                raise RuntimeError("PrefetchLoader batch schema "
                                   f"{[(k, v.shape, v.dtype) for k, v in b.items()]}")
        out["prefetch_batch_keys"] = sorted(schema)

        # 4. the trained checkpoint, served with the dataset's fitted PCA bases
        hp_s = configure("dgrad", dataset_root=root)
        model = build_model(hp_s)
        model.load_state_dict(checkpoints.load_checkpoint(ckpt)["model"])
        served = AnimationTask(hp_s, model, dev)
        served.warmup(3.0)
        clip = signal(3.0, int(hp_s.audio.sample_rate), 30)
        reset_counts(counters)
        ts, v = served.generate_vertices(clip, 1)
        for name, n in read_counts(counters, "data_train serve").items():
            path[name] += n
        host_task = AnimationTask(hp_s, model, dev, device_frontend=False)
        reset_counts(counters)
        ts_h, v_h = host_task.generate_vertices(clip, 1)
        # the host features take the per-window path, which solves through
        # frames_to_meshes, not K3
        for name, n in read_counts(counters, "data_train host frontend",
                                   zero=("decode_solve",)).items():
            path[name] += n
        path["bilstm_core_fwd"], path["bilstm_core_bwd"] = (bilstm_core.FWD_LAUNCHES,
                                                            bilstm_core.BWD_LAUNCHES)
        if v.shape != (len(ts), FLAME_COUNTS[0], 3) or not np.isfinite(v).all():
            raise RuntimeError(f"trained checkpoint: bad output {v.shape}")
        if ts_h != ts or v_h.shape != v.shape or not np.isfinite(v_h).all():
            raise RuntimeError(f"host frontend request: bad output {v_h.shape}")
        with ops.plain_versions():
            _, v_plain = served.generate_vertices(clip, 1)
        solver_, consts, dsc = served._decode_consts()
        sample = sorted({int(i) for i in np.linspace(0, len(ts) - 1, 8)})
        with torch.inference_mode():
            frame_idx, _, z, _ = served._overlap_prefix(clip)
            spk_t = torch.full((len(frame_idx),), 1, dtype=torch.long, device=dev)
            preds, _, _ = model.forward_windows(z, torch.from_numpy(frame_idx).long().to(dev),
                                                spk_t, raw_pca=True)
            dgrad = model.decode_to_anime(preds)[sample, 0].double().cpu().numpy()
            dt_request = float(decode_solve.delta_transforms(
                preds["dgrad_3d_scale_pca"][:, 0], preds["dgrad_3d_rotat_pca"][:, 0],
                dsc).abs().max())
            # the seeded bases of the serve phase on their first request, for scale
            idx0, _, z0, _ = task_seeded._overlap_prefix(sig)
            p0, _, _ = task_seeded.model.forward_windows(
                z0, torch.from_numpy(idx0).long().to(dev),
                torch.full((len(idx0),), spk, dtype=torch.long, device=dev), raw_pca=True)
            dt_seeded = float(decode_solve.delta_transforms(
                p0["dgrad_3d_scale_pca"][:, 0], p0["dgrad_3d_rotat_pca"][:, 0],
                task_seeded._decode_consts()[2]).abs().max())
        oracle = np.stack([solver.solve_host(d) for d in dgrad])
        out["serve"] = {"audio_s": 3.0, "windows": len(ts),
                        "oracle_frames": sample,
                        "oracle_max_abs_m": float(np.abs(v[sample] - oracle).max()),
                        "plain_max_abs_m": float(np.abs(v - v_plain).max()),
                        "host_frontend_max_abs_m_vs_device_frontend": float(np.abs(v_h - v).max()),
                        "max_abs_T_minus_T0": dt_request, "tol_m": ORACLE_TOL_M}
        if not (out["serve"]["oracle_max_abs_m"] <= ORACLE_TOL_M
                and out["serve"]["plain_max_abs_m"] <= PLAIN_TOL_M):
            raise RuntimeError(f"trained checkpoint: {out['serve']}")

        # 5. fault C4: K3 at the dataset's own projected coefficients, every frame of one
        #    sentence, against its plain version and the float64 decode + solve
        info = ds.info_list[0]
        coefs = np.asarray(ds._frame_store(info["npy_data_path:path"], int(info["anime_minfi:int"]),
                                           int(info["anime_maxfi:int"]))[3], np.float32)
        ks = model.scale_pca.compT.shape[1]
        cs = torch.from_numpy(np.ascontiguousarray(coefs[:, :ks])).to(dev)
        cr = torch.from_numpy(np.ascontiguousarray(coefs[:, ks:])).to(dev)
        with torch.inference_mode():
            x_kernel = decode_solve.decode_solve(cs, cr, dsc)
            torch.cuda.synchronize()
            x_plain = decode_solve.decode_solve_plain(cs, cr, dsc)
            verts = decode_solve.assemble_from_free(consts, solver_.spec, x_kernel,
                                                    consts.template_cnst).cpu().numpy()
            dt_data = float(decode_solve.delta_transforms(cs, cr, dsc).abs().max())
        c64 = coefs.astype(np.float64)
        comp = {n: getattr(model, f"{n}_pca") for n in ("scale", "rotat")}
        dec = [c64[:, sl] @ comp[n].compT.double().cpu().numpy().T
               + comp[n].means.double().cpu().numpy()
               for n, sl in (("scale", slice(0, ks)), ("rotat", slice(ks, None)))]
        frames64 = np.concatenate([dec[0].reshape(len(c64), -1, 6),
                                   dec[1].reshape(len(c64), -1, 3)], axis=-1)
        oracle = np.stack([solver.solve_host(f) for f in frames64])
        out["c4"] = {"frames": len(coefs), "max_abs_coef": float(np.abs(coefs).max()),
                     "max_abs_T_minus_T0": dt_data,
                     "seeded_bases_max_abs_T_minus_T0": dt_seeded,
                     "kernel_vs_plain_max_abs_m": float((x_kernel - x_plain).abs().max()),
                     "kernel_vs_float64_max_abs_m": float(np.abs(verts - oracle).max()),
                     "plain_tol_m": TOL["decode_solve"], "oracle_tol_m": ORACLE_TOL_M}
        if not (out["c4"]["kernel_vs_plain_max_abs_m"] <= TOL["decode_solve"]
                and out["c4"]["kernel_vs_float64_max_abs_m"] <= ORACLE_TOL_M):
            raise RuntimeError(f"C4: K3 at trained magnitudes {out['c4']}")
    return path


def reset_counts(counters):
    for mod in counters.values():
        mod.LAUNCHES = 0


def read_counts(counters, path, zero=()):
    """The launch counts since ``reset_counts``; raises if a kernel of ``path``
    never launched (or one named in ``zero`` did)."""
    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    for name, n in counts.items():
        if (n != 0) if name in zero else (n < 1):
            raise RuntimeError(f"{path}: {name} launched {n} times")
    return counts


def max_err(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def wires_phase(task, counters, sig, spk, v_f32, sample, oracle, smi):
    """One request per wire against the f32 wire's vertices (coef: against
    the float64 solve on the sampled frames), an ensembled request against the
    mean of its two runs, and a request with every kept constant dropped
    against the warm one."""
    import numpy as np
    import torch

    from sdfa_tpu_torch.audio import pipeline
    from sdfa_tpu_torch.viewer import frame

    n_w, v3 = len(v_f32), v_f32[0].size
    payload = {"f32": n_w * v3 * 4, "i16": n_w * v3 * 2, "i8d": n_w * v3 + v3 * 2,
               "coef": n_w * (85 + 180) * 4}
    lines, launches = {}, {}
    for wire in ("f32", "i16", "i8d", "coef"):
        task.generate_vertices(sig, spk, wire=wire)  # the wire's own first call
        walls = []
        for _ in range(3):
            reset_counts(counters)
            t0 = time.perf_counter()
            ts, verts = task.generate_vertices(sig, spk, wire=wire)
            walls.append(1e3 * (time.perf_counter() - t0))
        launches[wire] = read_counts(counters, f"wire {wire}",
                                     zero=("decode_solve",) if wire == "coef" else ())
        if verts.shape != v_f32.shape or verts.dtype != np.float32 or not np.isfinite(verts).all():
            raise RuntimeError(f"wire {wire}: bad output {verts.shape} {verts.dtype}")
        err = max_err(verts, v_f32)
        line = {"max_abs_m_vs_f32": err, "bytes_downloaded": payload[wire],
                "wall_ms": sorted(walls), "launches": launches[wire]}
        if wire == "coef":
            line["max_abs_m_vs_f64_solve"] = max_err(verts[sample], oracle)
            line["tol_m_vs_f64_solve"] = COEF_ORACLE_TOL_M
            if not line["max_abs_m_vs_f64_solve"] <= COEF_ORACLE_TOL_M:
                raise RuntimeError(f"coef wire vs the float64 solve: {line}")
        else:
            line["tol_m"] = WIRE_TOL_M[wire]
            if not err <= WIRE_TOL_M[wire]:
                raise RuntimeError(f"wire {wire} vs the f32 wire: {err} m > {WIRE_TOL_M[wire]}")
        lines[wire] = line

    # ensembling: the answer is the mean of the clip's run and of a run delayed by 100 ms
    t0 = time.perf_counter()
    _, v_ens = task.generate_vertices(sig, spk, ensembling_ms=100.0)
    ens_ms = 1e3 * (time.perf_counter() - t0)
    _, a0, _ = task.generate_animation(sig, spk)
    _, a1, _ = task.generate_animation(task._shifted(sig, 100.0), spk)
    v_mean, _ = frame.frames_to_meshes((a0 + a1) / 2.0, "dgrad_3d", task.device)
    ens_err = max_err(v_ens, v_mean)
    if not ens_err <= 1e-6 or not max_err(v_ens, v_f32) > 1e-7:
        raise RuntimeError(f"ensembled request: {ens_err} m from the mean of its two runs")

    # every kept constant dropped (frontend constants, stacked LSTM weights): the same bits
    _, warm = task.generate_vertices(sig, spk)
    pipeline.clear_const_cache()
    for module in task.model.modules():
        if hasattr(module, "_stacked"):
            module._stacked.clear()
    _, cold = task.generate_vertices(sig, spk)
    if not (np.array_equal(warm, cold) and np.array_equal(warm, v_f32)):
        raise RuntimeError("a request with its kept constants dropped differs from the warm one: "
                           f"{max_err(warm, cold)} m")
    emit({"phase": "wires", "audio_s": len(sig) / task.wspec.sr, "windows": n_w, "wires": lines,
          "ensembled_vs_mean_of_two_runs_m": ens_err, "ensembled_wall_ms": ens_ms,
          "kept_constants_dropped_vs_warm": "bit-equal", "card": smi})
    torch.cuda.empty_cache()
    return launches["i16"]


def session_phase(task, counters, sig, spk, ts_ref, v_ref, smi):
    """One ``StreamingSession`` fed the clip in uneven chunks, then flushed."""
    import numpy as np

    def run():
        sess = task.stream(spk, emit_batch=16, block_frames=16)
        rng, got, i = np.random.default_rng(0), [], 0
        while i < len(sig):
            n = int(rng.integers(400, 3000))
            got.extend(sess.push(sig[i:i + n]))
            i += n
        live = len(got)
        got.extend(sess.flush())
        return got, live

    run()  # warm-up: the block constants, the allocator
    reset_counts(counters)
    t0 = time.perf_counter()
    got, live = run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(counters, "session")
    err = max_err(np.stack([v for _, v in got]), v_ref)
    emit({"phase": "session", "frames": len(got), "frames_before_flush": live,
          "timeline_equal": [t for t, _ in got] == list(ts_ref), "max_abs_m_vs_offline": err,
          "tol_m": STREAM_TOL_M, "wall_ms": wall_ms, "wall_ms_per_frame": wall_ms / len(got),
          "launches": launches, "card": smi})
    if [t for t, _ in got] != list(ts_ref) or not err <= STREAM_TOL_M:
        raise RuntimeError(f"session vs offline: timeline or vertices differ ({err} m)")
    return launches


def drive_server(srv, clips, speakers, per_tick: int):
    """Open one stream per clip, push ``per_tick`` samples to each stream per
    tick until the clips end, flush and drain. → (frames by clip, wall ms of
    every tick, frames each tick delivered)."""
    sids = [srv.open(spk) for spk in speakers]
    got = {sid: [] for sid in sids}
    tick_ms, tick_frames = [], []

    def tick():
        t0 = time.perf_counter()
        out = srv.tick()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        tick_frames.append(sum(len(f) for f in out.values()))
        for sid, frames in out.items():
            got[sid].extend(frames)

    pos = 0
    while pos < max(len(c) for c in clips):
        for sid, clip in zip(sids, clips):
            if pos < len(clip):
                srv.push(sid, clip[pos:pos + per_tick])
        pos += per_tick
        tick()
    for sid in sids:
        srv.flush(sid)
    while not all(srv.is_done(sid) for sid in sids):
        tick()
    for sid in sids:
        srv.close(sid)
    return [got[sid] for sid in sids], tick_ms, tick_frames


def server_phase(task, counters, sr, smi):
    """``StreamingServer`` at capacity 8: 8 streams of different lengths and
    speakers per wire, each against its own offline request; two blocks of
    audio per stream and tick, so that a full tick is two block rounds of 128
    FreqLstm rows and one suffix call of up to 128 windows. Then capacity 32
    on i16 for its tick time."""
    import numpy as np

    from sdfa_tpu_torch.streaming import CoefDecoder, StreamingServer

    n, emit_batch, block = 8, 16, 16
    per_tick = 2 * block * task.wspec.hop_size
    clips = [signal(2.0 + 0.125 * k, sr, 40 + k) for k in range(n)]
    speakers = list(range(n))
    offline = [task.generate_vertices(c, k) for k, c in enumerate(clips)]
    decoder = CoefDecoder(task)
    v3 = offline[0][1][0].size
    frame_bytes = {"i16": v3 * 2, "i8d": v3, "coef": (85 + 180) * 4}
    tol = {"i16": WIRE_TOL_M["i16"] + STREAM_TOL_M, "i8d": WIRE_TOL_M["i8d"] + STREAM_TOL_M,
           "coef": STREAM_TOL_M}
    lines, launches = [], None
    for wire, pipelined in (("i16", False), ("i8d", False), ("coef", False), ("i16", True)):
        srv = StreamingServer(task, capacity=n, emit_batch=emit_batch, block_frames=block,
                              wire=wire, pipeline=pipelined)
        drive_server(srv, clips[:2], speakers[:2], per_tick)  # warm-up on the same server
        reset_counts(counters)
        got, tick_ms, tick_frames = drive_server(srv, clips, speakers, per_tick)
        counts = read_counts(counters, f"server {wire}",
                             zero=("decode_solve",) if wire == "coef" else ())
        launches = launches or counts
        # a delta stream starts from the template and catches up at 127 steps a frame: its
        # first frames may be further off and are reported apart
        skip = 8 if wire == "i8d" else 0
        errs, head_errs = [], []
        for k, frames in enumerate(got):
            ts_ref, v_ref = offline[k]
            if [t for t, _ in frames] != list(ts_ref):
                raise RuntimeError(f"server {wire}: stream {k}'s timeline differs from offline")
            verts = np.stack([v for _, v in frames])
            verts = decoder.decode(verts) if wire == "coef" else verts
            errs.append(max_err(verts[skip:], v_ref[skip:]))
            head_errs.append(max_err(verts[:8], v_ref[:8]))
        full = sorted(ms for ms, fr in zip(tick_ms, tick_frames) if fr >= n * (emit_batch - 2))
        n_frames = sum(tick_frames)
        fps = n_frames / (sum(tick_ms) / 1e3)
        lines.append({"wire": wire, "pipeline": pipelined, "streams": n,
                      "max_abs_m_vs_offline": max(errs), "tol_m": tol[wire],
                      "first_frames_left_out": skip, "max_abs_m_first_8_frames": max(head_errs),
                      "ticks": len(tick_ms), "full_ticks": len(full),
                      "full_tick_wall_ms_median": full[len(full) // 2] if full else None,
                      "full_tick_wall_ms_min_max": [full[0], full[-1]] if full else None,
                      "frames": n_frames, "frames_per_s": fps,
                      "times_real_time": fps / (60.0 * n), "bytes_per_frame": frame_bytes[wire],
                      "launches": counts})
        if not max(errs) <= tol[wire]:
            raise RuntimeError(f"server {wire}: {max(errs)} m from offline > {tol[wire]}")

    n32 = 32
    clips32 = [signal(2.0, sr, 80 + k) for k in range(n32)]
    srv = StreamingServer(task, capacity=n32, emit_batch=emit_batch, block_frames=block, wire="i16")
    drive_server(srv, clips32[:2], [0, 1], per_tick)
    got, tick_ms, tick_frames = drive_server(srv, clips32, [k % 8 for k in range(n32)], per_tick)
    if any(len(f) != len(got[0]) or not np.isfinite(np.stack([v for _, v in f])).all()
           for f in got):
        raise RuntimeError("server at capacity 32: a stream's frames are missing or not finite")
    full = sorted(ms for ms, fr in zip(tick_ms, tick_frames) if fr >= n32 * (emit_batch - 2))
    fps32 = sum(tick_frames) / (sum(tick_ms) / 1e3)
    emit({"phase": "server", "capacity": n, "emit_batch": emit_batch, "block_frames": block,
          "audio_s": [len(c) / sr for c in clips], "samples_per_stream_and_tick": per_tick,
          "runs": lines,
          "capacity_32_i16": {"full_ticks": len(full),
                              "full_tick_wall_ms_median": full[len(full) // 2] if full else None,
                              "frames_per_s": fps32, "times_real_time": fps32 / (60.0 * n32)},
          "card": smi})
    return launches


def tcp_phase(task, counters, sr, smi):
    """``ServeApp`` + ``StreamServerTCP`` on loopback: three clients on an i16
    service and one on a coef service with a ``CoefDecoder``, all at once."""
    import numpy as np

    from sdfa_tpu_torch.serve import ServeApp, StreamClient, StreamServerTCP
    from sdfa_tpu_torch.streaming import CoefDecoder

    clips = [signal(1.5 + 0.25 * k, sr, 60 + k) for k in range(4)]
    offline = [task.generate_vertices(c, k) for k, c in enumerate(clips)]
    decoder = CoefDecoder(task)
    services = []
    for wire in ("i16", "coef"):
        app = ServeApp(task, capacity=4, emit_batch=16, block_frames=16, wire=wire, pipeline=True)
        tcp = StreamServerTCP(("127.0.0.1", 0), app)
        thread = threading.Thread(target=tcp.serve_forever, daemon=True)
        thread.start()
        services.append((app, tcp, thread))
    results, errors = {}, []

    def client(k):
        try:
            on_coef = k == 3
            with StreamClient(services[on_coef][1].server_address) as c:
                c.sock.settimeout(SOCKET_TIMEOUT_S)
                sid = c.open(speaker=k)
                for lo in range(0, len(clips[k]), 2000):
                    c.push(sid, clips[k][lo:lo + 2000])
                c.flush(sid)
                # frames() returns when the stream's done marker arrives
                results[k] = (c.wire, list(c.frames(sid, decoder=decoder if on_coef else None)))
        except Exception as exc:  # reported below, on the main thread
            errors.append((k, repr(exc)))

    reset_counts(counters)
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SOCKET_TIMEOUT_S + 30)
        wall_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or len(results) != 4:
            raise RuntimeError(f"tcp clients failed: {errors}, {sorted(results)} finished")
        deadline = time.time() + 10
        while any(app.srv.live() for app, _, _ in services) and time.time() < deadline:
            time.sleep(0.02)
        free = [app.srv.live() == [] for app, _, _ in services]
    finally:
        for app, tcp, thread in services:
            tcp.shutdown()
            tcp.server_close()
            app.shutdown()
            thread.join(timeout=10)
    launches = read_counts(counters, "tcp")
    errs, wires = [], []
    for k in range(4):
        wire, frames = results[k]
        ts_ref, v_ref = offline[k]
        if [t for t, _ in frames] != list(ts_ref):
            raise RuntimeError(f"tcp client {k}: timeline differs from offline")
        errs.append(max_err(np.stack([v for _, v in frames]), v_ref))
        wires.append(wire)
    tols = [STREAM_TOL_M + (WIRE_TOL_M["i16"] if w == "i16" else 0.0) for w in wires]
    emit({"phase": "tcp", "clients": 4, "wires": wires, "max_abs_m_vs_offline": errs,
          "tol_m": tols, "done_markers": 4, "slots_free_afterwards": free,
          "frames": [len(results[k][1]) for k in range(4)], "wall_s": wall_s,
          "launches": launches, "card": smi})
    if wires != ["i16"] * 3 + ["coef"] or not all(free) or \
            not all(e <= t for e, t in zip(errs, tols)):
        raise RuntimeError(f"tcp: wires {wires}, errors {errs} m, slots free {free}")
    return launches


def profile_server_tick(task, sr, smi):
    """Full ticks of an i16 server at capacity 8 under ``torch.profiler``:
    device time by kernel per tick (two block rounds, one suffix call of up to
    128 windows, one download)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sdfa_tpu_torch.streaming import StreamingServer

    n, per_tick, ticks = 8, 2 * 16 * task.wspec.hop_size, 6
    clips = [signal((4 + 2 * ticks + 1) * per_tick / sr, sr, 90 + k) for k in range(n)]
    srv = StreamingServer(task, capacity=n, emit_batch=16, block_frames=16, wire="i16")
    sids = [srv.open(k) for k in range(n)]
    pos, frames = 0, 0
    host_ms = {"block_rounds": 0.0, "dispatch_suffix": 0.0, "collect": 0.0}

    def rounds(count):
        """``count`` ticks, the host's clock split by half of a tick: the block
        rounds and the suffix call only enqueue; collect waits for the card,
        copies the payload out of the pinned buffer and dequantizes it."""
        nonlocal pos, frames
        for _ in range(count):
            for sid, clip in zip(sids, clips):
                srv.push(sid, clip[pos:pos + per_tick])
            pos += per_tick
            t0 = time.perf_counter()
            srv._advance_blocks()
            t1 = time.perf_counter()
            pending = srv._dispatch()
            t2 = time.perf_counter()
            frames += sum(len(f) for f in srv.tick_collect(pending).values())
            t3 = time.perf_counter()
            for key, ms in zip(host_ms, (t1 - t0, t2 - t1, t3 - t2)):
                host_ms[key] += 1e3 * ms

    rounds(4)  # past the first blocks and the lookahead: every later tick is full
    frames, host_ms = 0, dict.fromkeys(host_ms, 0.0)
    rounds(ticks)
    unprofiled = {key: ms / ticks for key, ms in host_ms.items()}
    unprofiled_ms = sum(unprofiled.values())
    torch.cuda.synchronize()
    frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rounds(ticks)
        torch.cuda.synchronize()
    device, busy_ms = device_kernels(prof)
    emit({"phase": "profile_server_tick", "capacity": n, "wire": "i16", "ticks": ticks,
          "frames_per_tick": frames / ticks, "tick_wall_ms_unprofiled": unprofiled_ms,
          "tick_host_ms_unprofiled_by_half": unprofiled,
          "device_busy_ms_per_tick": busy_ms / ticks,
          "device_busy_share": busy_ms / ticks / unprofiled_ms,
          "top_device_ms_per_tick": [{"name": k[:80], "ms": ms / ticks, "calls_per_tick": c / ticks}
                                     for k, ms, c in device[:16]], "card": smi})


def device_kernels(prof, spans=()):
    """(name, device ms, launches) of every kernel and copy in a profile, largest
    first, and their sum; ``spans`` names record_function ranges to leave out."""
    from torch.autograd import DeviceType

    device = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key not in spans]
    device.sort(key=lambda item: -item[1])
    return device, sum(ms for _, ms, _ in device)


def profile_serving(task, requests, wall_ms_unprofiled, smi):
    """The serve phase's requests once more under ``torch.profiler``: device
    time by kernel per request and the busy share of an unprofiled request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for sig, spk in requests:
            task.generate_vertices(sig, spk)
        torch.cuda.synchronize()
    device, busy_ms = device_kernels(prof)
    n = len(requests)
    # a warm request uploads its signal and its window indices, and nothing else
    h2d = sum(c for k, _, c in device if "memcpy" in k.lower() and "htod" in k.lower()) / n
    if h2d > 2:
        raise RuntimeError(f"a warm request makes {h2d} host-to-device copies; the signal's and "
                           "the window indices' are the two it may make")
    emit({"phase": "profile_serve", "requests": n, "device_busy_ms_per_request": busy_ms / n,
          "h2d_copies_per_request": h2d,
          "wall_ms_unprofiled_median": wall_ms_unprofiled,
          "device_busy_share": busy_ms / n / wall_ms_unprofiled,
          "top_device_ms_per_request": [{"name": k[:80], "ms": ms / n, "calls_per_request": c / n}
                                        for k, ms, c in device[:14]], "card": smi})


def profile_step_clocks(build, dev, smi):
    """Where a step of the biLSTM step kernel spends its time: builds
    ``csrc/bilstm_layer.cu`` once more with ``-DSDFA_STEP_CLOCKS`` (thread 0 of
    the first block adds up SM clocks by part of a turn), runs one layer at
    224 and 256 rows x 64 steps, and prints clocks per step beside the least
    a step's 32 x 256 x 128 multiply-adds need on one SM (128 a clock)."""
    import ctypes

    import torch

    lib_path = os.path.join(build.BUILD_ROOT, "libbilstm_layer_step_clocks.so")
    src = os.path.join(build.CSRC, "bilstm_layer.cu")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-DSDFA_STEP_CLOCKS", "-o", lib_path,
                    src], capture_output=True, text=True, check=True, timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.sdfa_bilstm_layer.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sdfa_bilstm_layer_step_clocks.argtypes = [ctypes.c_void_p]
    steps, n_in = 64, 256
    for rows in (224, 256):
        gen = torch.Generator().manual_seed(rows)
        x = (0.5 * torch.randn(rows, steps, n_in, generator=gen)).to(dev)
        w_ih = (torch.randn(2, n_in, 1024, generator=gen) / 16).to(dev)
        w_hh = (torch.randn(2, 256, 1024, generator=gen) / 16).to(dev)
        xp = torch.empty(2, rows, steps, 1024, device=dev)
        out = torch.empty(rows, steps, 512, device=dev)

        def call():
            code = lib.sdfa_bilstm_layer(x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), None,
                                         xp.data_ptr(), out.data_ptr(), rows, steps, n_in, 256,
                                         rows, torch.cuda.current_stream(dev).cuda_stream)
            if code != 0:
                raise RuntimeError(f"bilstm_layer (step clocks build): CUDA error {code}")

        ms = time_ms(call, 5)
        clocks = (ctypes.c_longlong * 4)()
        if lib.sdfa_bilstm_layer_step_clocks(clocks) != 0:
            raise RuntimeError("could not read the step clocks")
        per_step = [c / steps for c in clocks]
        emit({"phase": "profile_step_clocks", "rows": rows, "steps": steps, "layer_ms": ms,
              "sm_clocks_per_step": dict(zip(("product", "warp_exchanges", "cell_and_send_h",
                                              "barrier_and_output"), per_step)),
              "sm_clocks_per_step_total": sum(per_step),
              "fma_floor_clocks_per_step": 32 * 256 * 128 / 128, "card": smi})


def profile_core_tiles(build, dev, smi):
    """The training core's tile choices side by side: builds ``csrc/bilstm_core.cu``
    as it is and with each compile-time choice changed (``-DSDFA_CORE_RG256=2``:
    32-row tiles at H = 256; ``-DSDFA_CORE_RG128=1``: 16-row tiles at H = 128;
    ``-DSDFA_CORE_MINB128=1``: one block to a multiprocessor at H = 128), and
    times both passes of each build at the train step's two shapes, twice."""
    import torch

    variants = {"as_built": [], "h256_32_row_tiles": ["-DSDFA_CORE_RG256=2"],
                "h128_16_row_tiles": ["-DSDFA_CORE_RG128=1"],
                "h128_one_block_per_sm": ["-DSDFA_CORE_MINB128=1"]}
    libs = build_variants(build, "bilstm_core", variants)
    times = {tag: {} for tag in variants}
    for steps, rows, hid in ((32, 6400, 128), (64, 100, 256)):
        gen = torch.Generator().manual_seed(hid)
        xp = (0.5 * torch.randn(2, steps, rows, 4 * hid, generator=gen)).to(dev)
        w_hh = (torch.randn(2, hid, 4 * hid, generator=gen) * hid ** -0.5).to(dev)
        dout = torch.randn(steps, rows, 2 * hid, generator=gen).to(dev)
        out, gates, dg = torch.empty_like(dout), torch.empty_like(xp), torch.empty_like(xp)
        cs = torch.empty(2, steps, rows, hid, device=dev)
        for turn in range(2):
            for tag, lib in libs.items():
                def call(entry, *tensors):
                    call_entry(lib, entry, tensors, (steps, rows, hid), dev)

                fwd = time_ms(lambda: call("sdfa_bilstm_core_fwd", xp, w_hh, out, gates, cs), 5)
                bwd = time_ms(lambda: call("sdfa_bilstm_core_bwd", gates, cs, w_hh, dout, dg), 5)
                times[tag].setdefault(f"{steps}x{rows}x{hid}", []).append(
                    {"fwd_ms": fwd, "bwd_ms": bwd})
    emit({"phase": "profile_core_tiles", "ms": times, "card": smi})


def build_variants(build, name, variants):
    """``csrc/<name>.cu`` built once per entry of ``variants`` (tag -> extra nvcc
    flags), side by side; -> {tag: the loaded library}."""
    import concurrent.futures
    import ctypes

    src = os.path.join(build.CSRC, name + ".cu")

    def compile_one(tag):
        path = os.path.join(build.BUILD_ROOT, f"lib{name}_{tag}.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *variants[tag], "-o", path, src],
                       capture_output=True, text=True, check=True, timeout=600)
        return ctypes.CDLL(path)

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(compile_one, variants)))


def call_entry(lib, entry, tensors, ints, dev):
    """``entry(pointers..., ints..., stream)`` of a library built by
    ``build_variants``, on ``dev``'s current stream; raises on a CUDA error."""
    import ctypes

    import torch

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    code = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
              torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA error {code}")


def profile_serving_tiles(build, dev, smi, k1_weights, dsc):
    """The compile-time choices of the two serving kernels redesigned last, side
    by side, each build timed twice in turns. ``csrc/freq_lstm.cu`` as it is and
    with 16-row tiles (``-DSDFA_FREQ_RG=1``) at 768 and 3072 rows;
    ``csrc/decode_solve.cu`` as it is (a ring of 3 stages, two blocks to a
    multiprocessor; the decode 4 windows a block) and with 4 stages and one
    block, 2 stages and two blocks (``-DSDFA_SOLVE_STAGES``,
    ``-DSDFA_SOLVE_MINB``), and the decode 8 and 16 windows a block
    (``-DSDFA_DECODE_WR``), at 256 and 216 windows, K split by the same rule
    from each build's own occupancy."""
    import ctypes

    import torch

    from sdfa_tpu_torch.ops import decode_solve

    def tiling(lib, entry, count):
        out = (ctypes.c_int * count)()
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        if fn(out) != 0:
            raise RuntimeError(f"{entry} failed")
        return list(out)

    empty = dict(device=dev, dtype=torch.float32)
    times = {"freq_lstm": {}, "decode_solve": {}}
    libs = build_variants(build, "freq_lstm", {"as_built": [],
                                               "16_row_tiles": ["-DSDFA_FREQ_RG=1"]})
    for rows in (K1_REQUEST_ROWS, K1_ROWS):
        x = torch.randn(rows, 32, 64, generator=torch.Generator().manual_seed(rows)).to(dev)
        out = torch.empty(rows, 256, **empty)
        for turn in range(2):
            for tag, lib in libs.items():
                clusters, row_tile, _ = tiling(lib, "sdfa_freq_lstm_tiling", 3)
                wave = clusters // 2 * row_tile
                chunk = max(wave, 1024 - 1024 % wave)  # whole waves, about 1024 rows
                n = min(rows, chunk)
                scratch = (torch.empty(2, n, 32, 512, **empty), torch.empty(n, 32, 256, **empty),
                           torch.empty(16, n, 256, **empty))
                ms = time_ms(lambda: call_entry(lib, "sdfa_freq_lstm",
                                                (x, *k1_weights, *scratch, out),
                                                (rows, 32, 64, 128, 256, chunk), dev), 5)
                times["freq_lstm"].setdefault(tag, {"resident_clusters": clusters,
                                                    "rows_per_cluster": row_tile})
                times["freq_lstm"][tag].setdefault(f"{rows}_rows_ms", []).append(ms)
    libs = build_variants(build, "decode_solve", {
        "as_built": [], "4_stages_1_block": ["-DSDFA_SOLVE_STAGES=4", "-DSDFA_SOLVE_MINB=1"],
        "2_stages_2_blocks": ["-DSDFA_SOLVE_STAGES=2"],
        "decode_8_windows_a_block": ["-DSDFA_DECODE_WR=8"],
        "decode_16_windows_a_block": ["-DSDFA_DECODE_WR=16"]})
    tp, nf = dsc.p.shape[1:]
    n_pad = dsc.p_t.shape[0]
    for windows in (K3_WINDOWS, K3_REQUEST_WINDOWS):
        gen = torch.Generator().manual_seed(windows)
        coef_s = torch.randn(windows, 85, generator=gen).to(dev)
        coef_r = torch.randn(windows, 180, generator=gen).to(dev)
        dt, out = torch.empty(windows, 9, tp, **empty), torch.empty(windows, 3, nf, **empty)
        for turn in range(2):
            for tag, lib in libs.items():
                resident = tiling(lib, "sdfa_decode_solve_tiling", 4)[0]
                parts = decode_solve.k_parts(3 * windows, n_pad, 3 * tp, resident)
                part = torch.empty(parts, 3 * windows, n_pad, **empty)
                ms = time_ms(lambda: call_entry(
                    lib, "sdfa_decode_solve",
                    (coef_s, coef_r, dsc.basis_s, dsc.means_s, dsc.basis_r, dsc.means_r, dsc.p_t,
                     dsc.t0, dsc.x0, dt, part, out),
                    (windows, 85, 180, tp, nf, n_pad, parts), dev), 5)
                times["decode_solve"].setdefault(tag, {"resident_blocks": resident})
                times["decode_solve"][tag].setdefault(f"{windows}_windows", {"k_parts": parts,
                                                                              "ms": []})
                times["decode_solve"][tag][f"{windows}_windows"]["ms"].append(ms)
    emit({"phase": "profile_serving_tiles", "ms": times, "card": smi})


def profile_train_step(exp, batches, smi, step_ms_unprofiled):
    """Three more train steps under ``torch.profiler``: device time by stage
    (the ``record_function`` spans of ``Experiment.train_step``) and by
    kernel, and the device's busy time per step as a share of the unprofiled
    step (the profiler slows the host, so the profiled span would understate it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches[:3]:
            exp.train_step(batch)
        torch.cuda.synchronize()
    span_ms = 1e3 * (time.perf_counter() - t0)
    spans = ("train/upload", "train/forward_loss", "train/backward", "train/clip_adam")
    device, busy_ms = device_kernels(prof, spans)
    # a span's device time is that of the kernels launched inside it on the calling
    # thread; autograd launches the backward's kernels from its own thread, so the
    # backward's share is what the other three leave
    stages = {e.key: e.device_time_total / 1e3 / 3 for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and e.key in spans and e.key != spans[2]}
    stages[spans[2]] = busy_ms / 3 - sum(stages.values())
    emit({"phase": "profile", "steps": 3, "profiled_span_ms": span_ms,
          "device_busy_ms_per_step": busy_ms / 3, "step_ms_unprofiled": step_ms_unprofiled,
          "device_busy_share": busy_ms / 3 / step_ms_unprofiled,
          "stage_device_ms_per_step": stages,
          "top_device_ms_per_step": [{"name": k[:80], "ms": ms / 3, "calls_per_step": n / 3}
                                     for k, ms, n in device[:16]], "card": smi})


if __name__ == "__main__":
    main()
