"""The PCA fit's covariance route at the full VOCASET scale width, on the card.

``sdfa_tpu_torch.data.vocaset.preload.fit_pca(route="gram")`` on seeded
synthetic rows at the scale part's 59856 columns (9976 triangles x 6): a
latent of ``--latent`` directions with a power-law spectrum (variance
j^-1.6, so that 97% of it takes a couple of hundred components, as the real
dgrad scale basis does) times a random basis, plus a little noise, made on
the device in row chunks and kept on the host as float32, as the training
frames are. It prints the card, the peak of device memory the fit allocated
(``torch.cuda.max_memory_allocated``) beside the card's total, the seconds of
the fit (the fit's log lines give the covariance accumulation's share and
the iterations), the count and the components' orthonormality; then both
routes (thin SVD, covariance) on the first ``--check_rows`` rows at the same
width, held together. Its last line is one JSON object with the numbers.

Usage (on a machine with a CUDA card; about 18 GB of host memory at the
default 77000 rows):

    python tools/pca_gram_probe.py [--rows 77000] [--cols 59856] [--latent 2000]
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sdfa_tpu_torch.data.vocaset import preload  # noqa: E402

CHECK_TOL = 1e-5  # the gate of the fitted components against numpy's SVD in the tests


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def synthetic_rows(rows: int, cols: int, latent: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = torch.arange(1, latent + 1, device=device, dtype=torch.float32) ** -0.8
    basis = torch.randn(latent, cols, generator=gen, device=device) / cols ** 0.5
    out = np.empty((rows, cols), np.float32)
    for i in range(0, rows, 4096):
        r = min(4096, rows - i)
        z = torch.randn(r, latent, generator=gen, device=device) * scale
        x = z @ basis + 1e-4 * torch.randn(r, cols, generator=gen, device=device)
        out[i:i + r] = x.cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=77000)
    ap.add_argument("--cols", type=int, default=59856)
    ap.add_argument("--latent", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check_rows", type=int, default=4000,
                    help="both routes on this many first rows, held together (0: skip)")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    if args.platform == "gpu" and not torch.cuda.is_available():
        sys.exit("pca_gram_probe: no CUDA device (pass --platform cpu for a small run)")
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    print("card:", card(), flush=True)

    t0 = time.perf_counter()
    data = synthetic_rows(args.rows, args.cols, args.latent, args.seed, device)
    make_s = time.perf_counter() - t0
    print(f"rows {data.shape} float32 made in {make_s:.2f} s", flush=True)

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    comps, mean = preload.fit_pca(data, device=device, route="gram")
    fit_s = time.perf_counter() - t0
    gram_gib = args.cols ** 2 * 8 / 2 ** 30
    out = {"card": card(), "rows": args.rows, "cols": args.cols, "latent": args.latent,
           "components": int(len(comps)), "fit_s": fit_s,
           "covariance_gib": gram_gib,
           "orthonormal_max_abs": float(np.abs(comps @ comps.T - np.eye(len(comps))).max()),
           "mean_finite": bool(np.isfinite(mean).all())}
    if device.type == "cuda":
        out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
        out["device_total_gib"] = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    if args.check_rows:
        sub = data[:args.check_rows]
        t0 = time.perf_counter()
        by_route = {r: preload.fit_pca(sub, device=device, route=r) for r in ("svd", "gram")}
        (c_svd, m_svd), (c_gram, m_gram) = by_route["svd"], by_route["gram"]
        out["check"] = {"rows": len(sub), "components": [len(c_svd), len(c_gram)],
                        "max_abs_gram_vs_svd": float(np.abs(c_gram - c_svd).max())
                        if c_gram.shape == c_svd.shape else None,
                        "means_max_abs": float(np.abs(m_gram - m_svd).max()),
                        "tol": CHECK_TOL, "s": time.perf_counter() - t0}
    for key, val in out.items():
        print(f"{key}: {val}")
    print(json.dumps(out))
    if not (out["orthonormal_max_abs"] <= 1e-8 and out["mean_finite"]):
        sys.exit("pca_gram_probe: the components are not orthonormal")
    check = out.get("check")
    if check and not (check["max_abs_gram_vs_svd"] is not None
                      and check["max_abs_gram_vs_svd"] <= CHECK_TOL):
        sys.exit("pca_gram_probe: the two routes disagree")


if __name__ == "__main__":
    main()
