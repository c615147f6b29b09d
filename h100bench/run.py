#!/usr/bin/env python3
"""The benchmark of ``sdfa_tpu_torch`` on the H100, one cell a run:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` there names the cell's
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``,
whose ``kind`` picks the driver ``drivers/<kind>.py``), per-layer metrics
(``metrics/<name>.py``, each a ``read(ctx)``) and limits
(``limits/<cell>.json``). A new cell, mix, metric or limit table is a new file
and an entry; nothing here changes.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
``torch.profiler`` trace of the window. ``correct`` holds what the window
delivered to the plain reference (``reference/``); each number compared is
printed beside its limit, last on standard error and last in the result line.

``--rehearse`` runs the cell on the CPU through the kernels' plain versions,
without looking for a card, and prints no metric: the CPU tests' route.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

T_ENTRY = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.getcwd()
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))
FORBIDDEN = ("jax", "jaxlib", "flax", "sdfa_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (its start time in /proc), or since
    this file began to run where /proc does not say."""
    try:
        with open("/proc/self/stat") as fp:
            start_ticks = float(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if age >= 0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_ENTRY


T_BORN = time.perf_counter() - _process_age_s()


def _environment():
    """Every build and kernel cache at a fixed directory inside the checkout,
    so that only a checkout's first run builds."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(build, "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")


def load_cell(workload: str, root: str = None):
    """(benchmark, cell, configuration, mix, per-layer metrics that this cell
    reports, limits) by the names in ``BENCHMARK.json``."""
    root = root or ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as fp:
        cfg = json.load(fp)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fp:
        mix = json.load(fp)
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    limits_path = os.path.join(HERE, "limits", workload + ".json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as fp:
            limits = json.load(fp)["limits"]
    return bench, cell, cfg, mix, e2e, per_layer, limits


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("h100bench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


class Env:
    """What a driver gets: the cell's files, the run's arguments, and the
    harness's clocks, profiler and device hooks."""

    def __init__(self, args, cell, cfg, mix, device, rehearse: bool):
        import torch

        self.torch = torch
        self.args, self.cell, self.cfg, self.mix = args, cell, cfg, mix
        self.seed, self.seconds, self.trace = int(args.seed), float(args.seconds), bool(args.trace)
        self.device, self.rehearse = device, rehearse
        self.root = ROOT
        self.tmpdir = os.environ.get("TMPDIR") or "/tmp"

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def setup_done(self) -> float:
        """``setup_s``: seconds from the process's start to now."""
        return time.perf_counter() - T_BORN

    def profiler(self):
        if not self.trace or self.rehearse:
            return None
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def reduce_trace(self, prof, span: str):
        if prof is None:
            return None
        from h100bench.tracing import Trace

        return Trace.from_profile(prof, self.tmpdir, span)

    def note(self, **values):
        """A line of the run's phases and counts on standard error."""
        print("h100bench: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                                       f"{k}={json.dumps(v)}" for k, v in values.items()),
              file=sys.stderr, flush=True)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU, the kernels' plain versions, no card looked for, no metric")
    args = ap.parse_args(argv)
    _environment()
    # where TensorFlow is installed, the training cells' Experiment opens a
    # torch.utils.tensorboard SummaryWriter, which imports tensorflow, which
    # imports jax and jaxlib (a SummaryWriter alone does so with TensorFlow
    # 2.x installed); without it TensorBoard uses its own stub
    sys.modules.setdefault("tensorflow", None)
    bench, cell, cfg, mix, e2e, per_layer, limits = load_cell(args.workload)

    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        chips = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"h100bench: the cell needs {chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)  # the program, at the checkout's root
    driver = importlib.import_module(f"h100bench.drivers.{mix['kind']}")
    env = Env(args, cell, cfg, mix, device, args.rehearse)
    out = driver.run(env)

    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {found}: the port must not use JAX", file=sys.stderr)
        return 4

    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {}, "device": {}}
    if args.rehearse and args.trace:
        # every reader of the cell runs, and what it reads from a CPU run goes
        # to standard error only: it is no device's number
        from h100bench.metrics_ctx import Context

        ctx = Context(cell, cfg, mix, out)
        for m in per_layer:
            print(f"h100bench: rehearsal reader {m['name']} read {metric_reader(m['name'])(ctx)!r}",
                  file=sys.stderr)
    if not args.rehearse:
        kind = torch.cuda.get_device_name(0)
        result["device"] = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
                            "memory_peak_bytes": int(out["memory_peak"])}
        if args.trace:
            from h100bench.metrics_ctx import Context

            ctx = Context(cell, cfg, mix, out)
            for m in per_layer:
                value = metric_reader(m["name"])(ctx)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
            tr = out["trace"]
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.top_ops(10)],
                                   "idle_gaps": [[n, s] for n, s in tr.idle_gaps(10)]}
            result["card"] = card_line()
        else:
            values = dict(out["e2e"], setup_s=out["setup_s"])
            for m in e2e:
                result["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                                "unit": m["unit"]}
    checks, ok = {}, True
    for name, value in out["checks"].items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    if not limits:
        ok = False  # no limit set: nothing is proven
    result["correct"] = bool(ok and out["failed"] == 0)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
