#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdfa_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card's name and power limit, torch / CUDA / nvcc versions.
2. build: compiles the three CUDA kernels from ``sdfa_tpu_torch/csrc``.
3. kernels: runs each kernel at the serving path's shapes, holds it
   against its plain PyTorch version on the same inputs, and times both
   with CUDA events.
4. serve: the flagship ``dgrad`` config at full width (seeded weights,
   seeded PCA bases at the shipped dims, a synthetic template with FLAME's
   5023 vertices / 9976 triangles / 1261 free vertices) serves three 3 s
   requests through ``AnimationTask.generate_vertices``; every kernel's
   launch counter must move during those requests.
5. check: one request again through the plain versions on the card, and
   sampled frames against the float64 host solve.

Any failure raises, so the script exits non-zero and prints no result
line. The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

SEED = 0
K1_ROWS = 4 * 768     # 4 clips x a 3 s clip's 768-frame grid
K2_WINDOWS = 256      # windows per suffix call
K3_WINDOWS = 256
TOL = {"freq_lstm": 1e-4, "bilstm2": 1e-4, "decode_solve": 1e-5}  # max |kernel - plain|
PLAIN_TOL_M = 1e-4    # wav -> vertices through kernels vs through plain versions
ORACLE_TOL_M = 1e-4   # sampled frames vs the float64 host solve


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def signal(seconds: float, sr: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(110.0, 220.0)
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.4 * np.sin(2 * np.pi * 3 * t))
    return (sig + 0.02 * rng.standard_normal(len(t))).clip(-1, 1).astype(np.float32)


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "sdfa_tpu_torch")):
        sys.exit("chip_smoke.py: the sdfa_tpu_torch package is not beside this script")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sdfa_tpu_torch import ops
    from sdfa_tpu_torch.compat import init_params
    from sdfa_tpu_torch.config import configure
    from sdfa_tpu_torch.mesh import FLAME_COUNTS, synthetic_template
    from sdfa_tpu_torch.models import build_model
    from sdfa_tpu_torch.ops import bilstm2, build, decode_solve, freq_lstm
    from sdfa_tpu_torch.task import AnimationTask
    from sdfa_tpu_torch.viewer import frame

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    for name in ("freq_lstm", "bilstm2", "decode_solve"):
        build.load_library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {k: v["seconds"] for k, v in build.BUILD_INFO.items()},
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

    # --- each kernel against its plain version at the path's shapes -------
    enc = model.audio_encoder
    fl = enc.built_layers_6
    w_ih, w_hh, gb = fl.lstm.layer_weights(0)
    x1 = torch.randn(K1_ROWS, fl.freq_length, w_ih.shape[1], generator=torch.Generator()
                     .manual_seed(1)).to(dev)
    k1 = (x1, w_ih, w_hh, gb, fl.proj.weight(), fl.proj.bias)
    lw = [enc.built_layers_9.layer_weights(layer) for layer in range(2)]
    x2 = (0.5 * torch.randn(K2_WINDOWS, 64, 256, generator=torch.Generator()
                            .manual_seed(2))).to(dev)
    k2 = (x2, *lw[0], *lw[1])
    g3 = torch.Generator().manual_seed(3)
    k3 = (torch.randn(K3_WINDOWS, 85, generator=g3).to(dev),
          torch.randn(K3_WINDOWS, 180, generator=g3).to(dev), dsc)
    cases = [("freq_lstm", freq_lstm.freq_lstm, freq_lstm.freq_lstm_plain, k1,
              "sdfa_tpu_torch/csrc/freq_lstm.cu", "sdfa_tpu/ops/pallas_freq_lstm.py:187"),
             ("bilstm2", bilstm2.bilstm2, bilstm2.bilstm2_plain, k2,
              "sdfa_tpu_torch/csrc/bilstm2.cu", "sdfa_tpu/ops/pallas_bilstm2.py:52"),
             ("decode_solve", decode_solve.decode_solve, decode_solve.decode_solve_plain, k3,
              "sdfa_tpu_torch/csrc/decode_solve.cu", "sdfa_tpu/ops/pallas_decode_solve.py:229")]
    report = []
    with torch.inference_mode():
        for name, kernel, plain, args, source, replaces in cases:
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = float((got - want).abs().max())
            finite = bool(torch.isfinite(got).all())
            ms = time_ms(lambda: kernel(*args), 5)
            plain_ms = time_ms(lambda: plain(*args), 5)
            emit({"phase": "kernel", "name": name, "shape": list(got.shape),
                  "max_abs_err": err, "tol": TOL[name], "ms": ms, "plain_ms": plain_ms,
                  "card": smi})
            if not finite or not err <= TOL[name]:
                raise RuntimeError(f"{name}: kernel disagrees with its plain version: "
                                   f"max |diff| {err} > {TOL[name]} (finite={finite})")
            report.append({"name": name, "route": "cuda", "source": source,
                           "replaces": replaces, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms})

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
        frame_idx, _, z = task._overlap_prefix(sig0)
        idx = torch.from_numpy(frame_idx[sample]).long().to(dev)
        spk = torch.full((len(sample),), spk0, dtype=torch.long, device=dev)
        preds, _ = model.forward_windows(z, idx, spk)
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

    for entry in report:
        entry["launches"] = launches[entry["name"]]
    emit({"kernels": report})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
