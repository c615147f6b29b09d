"""Data-parallel training, one rank a card, each rank in the ``Trainer``'s loop
shape of ``drivers/train.py``: its own raw-mode reader on a
``ThreadPrefetchIterable`` over ``raw_batches(pairs x world, shard=(rank,
world))``, ``parallel.mesh.all_ranks_agree`` before each upload (as
``Trainer._agreed``), ``Experiment.train_step`` with ``trainer.multihost``.

The process the harness starts is rank 0 on ``cuda:0``. Once it has written
the corpus it starts ranks 1 to world - 1 (``python -m
h100bench.drivers.train_dp``), one a card, with a launcher's environment
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
and ``NCCL_SHM_DISABLE=1``; NCCL's log goes to the run's directory, and the
transports it chose are noted. Rank 0's clock opens and ends the warm-up and
the window: before each step the others learn from a broadcast on the host
group whether to stop, so every rank takes the same steps. That broadcast
belongs to this module: it is no collective of the program and lies outside
its counters and stage spans.

``train_windows_per_s`` counts the windows of every rank over rank 0's
window; the trace is rank 0's; ``counts`` carries the delta of the program's
``parallel.mesh.CALLS`` over the window, where the program has it. ``correct``
takes ``dgrad-train``'s numbers: the first global steps against the float64
reference on the global batch (the ranks' batches put back together as
``parallel.mesh.shard_rows`` split it: a W-rank step is the one-process step
on the global batch), and each rank's reader rebuilt from the corpus files.
Each rank leaves its first batches and their draws in the run's directory
(under ``TMPDIR``), which rank 0 removes once it has read them.

The note line also gives each rank's host in the window: its processor
seconds over the window's, how often a step the kernel took a processor from
it (involuntary context switches), the processors it may run on, the host's
load at the window's start and end, and rank 0's garbage collections by
generation (``profiling.GC_COLLECTIONS``, every thread's) beside its
``host/gc`` spans in a traced run (the traced thread's).

``--rehearse`` runs two ranks on the CPU over gloo. A rank whose parent dies
is killed with it; rank 0 stops every rank it started before it returns."""

from __future__ import annotations

import argparse
import ctypes
import datetime
import glob
import json
import os
import re
import resource
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from . import train

REHEARSE_WORLD = 2
GROUP_TIMEOUT_S = 900  # a collective that waits longer raises (a first run builds kernels)
JOIN_S = 300           # rank 0's wait for the others to leave after the window


class Loop(train.Loop):
    """``train.Loop``, and before each upload the ranks agree that each has a
    batch, as ``Trainer._agreed`` has them do."""

    def fetch(self):
        from sdfa_tpu_torch.parallel import mesh as mesh_lib

        t0 = time.perf_counter()
        with record_function("bench/next_batch"):
            host = next(self.it, None)
            if host is None:
                self.it = iter(self.loader)
                self.epochs += 1
                host = next(self.it)
        self.wait_s += time.perf_counter() - t0
        mesh_lib.all_ranks_agree(host is not None, self.exp.mesh)
        return host, self.exp.put_batch(host)


def agreed_stop(stop: bool, mesh) -> bool:
    """Rank 0's ``stop`` on every rank, by a broadcast on the host group."""
    flag = torch.tensor([int(stop)], dtype=torch.int64)
    with record_function("bench/stop"):
        dist.broadcast(flag, 0, group=mesh.host_group)
    return bool(flag.item())


def unshard(parts: List[Dict]) -> Dict[str, np.ndarray]:
    """The global batch whose pair-keeping shards are ``parts``, rank 0's
    first: every rank's first frames, then every rank's second frames."""
    out = {}
    for key in parts[0]:
        arrays = [np.asarray(p[key]) for p in parts]
        halves = [len(a) // 2 for a in arrays]
        out[key] = np.concatenate([a[:h] for a, h in zip(arrays, halves)]
                                  + [a[h:] for a, h in zip(arrays, halves)])
    return out


def expected_collectives(model, hp) -> int:
    """The program's collectives a step by the model and the configuration: a
    pair per BatchNorm module, the gradient exchange, the dynamic scalers'
    terms where the loss has them, the step's metrics and the batch's
    agreement."""
    from sdfa_tpu_torch.nn.layers import BatchNorm

    norms = sum(isinstance(m, BatchNorm) for m in model.modules())
    return 2 * norms + 1 + int(bool(hp.loss.get("dynamic_scalar", False))) + 1 + 1


def rank_steps(env, rank: int, world: int, rundir: str) -> Dict:
    """One rank's part: set-up, the first steps, the warm-up, the window.
    Rank 0's result carries what the checks and the metrics need."""
    from sdfa_tpu_torch import profiling
    from sdfa_tpu_torch.data.thread_prefetch import ThreadPrefetchIterable
    from sdfa_tpu_torch.parallel import mesh as mesh_lib
    from sdfa_tpu_torch.parallel import multihost
    from sdfa_tpu_torch.train.trainer import Experiment

    mix = env.mix
    pairs, n_check = int(mix["batch_pairs"]), int(mix["check_steps"])
    hp, model, state, params, train_set = train.inputs(env)
    hp.trainer.set_key("multihost", True)
    drawn = train.record_items(train_set, pairs * n_check)
    multihost.maybe_initialize_distributed(
        backend=multihost.default_backend(env.device),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    exp = Experiment(hp, model, log_dir=os.path.join(rundir, f"rank{rank}"), device=env.device,
                     seed=env.seed)
    exp.model.load_state_dict(state)  # the seeded weights, over the program's own init
    mesh_lib.replicate(exp.mesh, exp.model)
    if (exp.mesh.world, exp.mesh.rank) != (world, rank):
        raise RuntimeError(f"rank {rank} of {world} joined as {exp.mesh.rank} of {exp.mesh.world}")

    class Epochs:
        def __iter__(self):
            return train_set.raw_batches(pairs * world, shard=(rank, world))

    loop = Loop(exp, ThreadPrefetchIterable(Epochs()))
    before = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    batches, losses, first_grad = [], [], None
    pending = loop.fetch()
    for i in range(n_check):
        host, batch = pending
        batches.append(host)
        metrics = exp.train_step(batch)
        pending = loop.fetch()
        losses.append(metrics["total"].detach().clone())
        if i == 0 and rank == 0:  # the first gradient as Adam holds it: m = (1 - beta1) g
            b1 = exp.optimizer.param_groups[0]["betas"][0]
            named = dict(exp.model.named_parameters())
            state_of = {k: exp.optimizer.state.get(named[k], {}) for k in params}
            first_grad = {k: (state_of[k]["exp_avg"].detach() / (1 - b1) if "exp_avg" in state_of[k]
                              else torch.zeros_like(named[k])) for k in params}
    after = {k: v.detach().clone() for k, v in exp.model.state_dict().items()}
    t_warm = time.perf_counter()
    while not agreed_stop(rank == 0 and time.perf_counter() - t_warm >= float(mix["warm_s"]),
                          exp.mesh):
        exp.train_step(pending[1])
        pending = loop.fetch()
    env.sync()
    setup_s = env.setup_done()

    calls = getattr(mesh_lib, "CALLS", None)  # the program's counters, where it has them
    sent = getattr(mesh_lib, "BYTES", None)
    gc_counts = getattr(profiling, "GC_COLLECTIONS", None)
    calls0 = dict(calls) if calls is not None else None
    bytes0 = dict(sent) if sent is not None else None
    gc0 = dict(gc_counts) if gc_counts is not None else None
    usage0, cpu0, load0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time(), \
        os.getloadavg()[0]
    steps, windows = 0, 0
    wait0, epochs0 = loop.wait_s, loop.epochs
    prof = env.profiler() if rank == 0 else None
    with prof if prof is not None else nullcontext():
        t0 = time.perf_counter()
        while not agreed_stop(rank == 0 and time.perf_counter() - t0 >= env.seconds, exp.mesh):
            with record_function("bench/step"):
                exp.train_step(pending[1])
                windows += len(pending[0]["speaker_id"])
                steps += 1
                pending = loop.fetch()
        env.sync()
        window_s = time.perf_counter() - t0
    usage = resource.getrusage(resource.RUSAGE_SELF)
    host = {"cpu_share": (time.process_time() - cpu0) / window_s,
            "preempted_per_step": (usage.ru_nivcsw - usage0.ru_nivcsw) / max(steps, 1),
            "cpus": len(os.sched_getaffinity(0)), "load": [load0, os.getloadavg()[0]]}
    if gc0 is not None:
        host["gc"] = {str(g): n - gc0.get(g, 0) for g, n in sorted(gc_counts.items())}
    counts = {"steps": steps, "windows": windows, "epochs": loop.epochs - epochs0,
              "rows": len(batches[0]["speaker_id"]), "world": world,
              "collectives_by_model": expected_collectives(exp.model, hp)}
    if calls0 is not None:
        delta = {k: v - calls0.get(k, 0) for k, v in calls.items() if v != calls0.get(k, 0)}
        counts["collectives"] = sum(delta.values())
        counts["collectives_by_op"] = delta
        counts["collective_bytes"] = sum(v - bytes0.get(k, 0) for k, v in sent.items())
    out = dict(batches=batches, drawn=drawn[:pairs * n_check], counts=counts, setup_s=setup_s,
               window_s=window_s, loader_wait_s=loop.wait_s - wait0, host=host)
    if rank == 0:
        out.update(losses=[float(v) for v in losses], first_grad=first_grad, before=before,
                   after=after, params=params, hp=json.loads(json.dumps(hp)),
                   trace=env.reduce_trace(prof, "bench/step"), memory_peak=env.memory_peak())
    del loop, exp, model, pending
    multihost.shutdown()
    env.free()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as fp:
            return fp.read()[-n:]
    except OSError:
        return ""


def nccl_transports(rundir: str) -> List[str]:
    """The transports NCCL's logs name for its channels ("P2P/CUMEM", "NET/Socket")."""
    found = set()
    for path in glob.glob(os.path.join(rundir, "nccl.*.log")):
        with open(path, errors="replace") as fp:
            found.update(re.findall(r" via (\S+)", fp.read()))
    return sorted(found)


def run(env) -> Dict:
    from .. import dataset, program
    from ..reference.reader import Reader, compare as compare_reader
    from ..reference.training import Step

    world = REHEARSE_WORLD if env.rehearse else int(env.cell["chips"])
    rundir = os.path.join(env.tmpdir, f"h100bench_train_dp_{os.getpid()}")
    os.makedirs(rundir, exist_ok=True)
    # the corpus once, before any other rank reads it
    c = env.mix["corpus"]
    dataset.corpus(os.path.join(env.root, "build", "h100bench_data"),
                   program.hparams(env.cfg).model.face_data_type, int(c["sentences"]),
                   float(c["seconds"]))
    launch = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
              "WORLD_SIZE": str(world), "NCCL_SHM_DISABLE": "1", "NCCL_DEBUG": "INFO",
              "NCCL_DEBUG_FILE": os.path.join(rundir, "nccl.%p.log")}
    saved = {k: os.environ.get(k) for k in list(launch) + ["RANK", "LOCAL_RANK"]}
    os.environ.update(launch, RANK="0", LOCAL_RANK="0")
    procs, logs = [], []
    done = threading.Event()

    def watch():
        """A rank that fails before the window ends stops the run at once:
        the others would wait on it in a collective."""
        while not done.wait(1.0):
            for proc, log in zip(procs, logs):
                if proc.poll() not in (None, 0):
                    print(f"h100bench: a rank exited {proc.returncode}: {_tail(log)}",
                          file=sys.stderr, flush=True)
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    os._exit(5)

    try:
        for rank in range(1, world):
            logs.append(os.path.join(rundir, f"rank{rank}.log"))
            with open(logs[-1], "w") as fp:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "h100bench.drivers.train_dp",
                     "--workload", env.cell["name"], "--seed", str(env.seed),
                     "--seconds", str(env.seconds), "--rundir", rundir,
                     "--parent", str(os.getpid())] + (["--rehearse"] if env.rehearse else []),
                    cwd=env.root, stdout=fp, stderr=subprocess.STDOUT,
                    env=dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank))))
        threading.Thread(target=watch, daemon=True).start()
        mine = rank_steps(env, 0, world, rundir)
        done.set()
        end = time.monotonic() + JOIN_S
        for proc, log in zip(procs, logs):
            try:
                rc = proc.wait(timeout=max(end - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"a rank still runs {JOIN_S} s after the window: {_tail(log)}")
            if rc != 0:
                raise RuntimeError(f"a rank exited {rc}: {_tail(log)}")
    finally:
        done.set()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ranks = [mine] + [torch.load(os.path.join(rundir, f"rank{r}.pt"), weights_only=False)
                      for r in range(1, world)]
    transports = nccl_transports(rundir) or ["gloo" if env.rehearse else "not logged"]
    shutil.rmtree(rundir, ignore_errors=True)  # kept where a rank failed, for its log

    t_ref = time.perf_counter()
    n_check = int(env.mix["check_steps"])
    hpd, dev = mine["hp"], env.device
    global_batches = [unshard([r["batches"][i] for r in ranks]) for i in range(n_check)]
    ref = Step(hpd, mine["before"], mine["params"], dev, env.seed)
    checks = train.compare(ref, global_batches, mine["losses"], mine["first_grad"],
                           mine["before"], mine["after"], mine["params"])
    pairs = int(env.mix["batch_pairs"])
    reader = Reader(hpd, hpd["dataset_anime"]["root"])
    for r in ranks:
        numbers = compare_reader(reader, r["batches"],
                                 [r["drawn"][i * pairs:(i + 1) * pairs] for i in range(n_check)])
        for k, v in numbers.items():
            checks[k] = max(checks.get(k, 0.0), v)
    counts = dict(mine["counts"], windows=sum(r["counts"]["windows"] for r in ranks))
    steps = counts["steps"]
    spans = gc_spans = None
    if mine["trace"] is not None:
        annotations = [name for name, cat, _, _ in mine["trace"].host if cat == "user_annotation"]
        spans = sum(1 for name in annotations if name.startswith("mesh/"))
        gc_spans = annotations.count("host/gc")
    env.note(setup_s=mine["setup_s"], window_s=mine["window_s"],
             reference_s=time.perf_counter() - t_ref, loader_wait_s=mine["loader_wait_s"],
             losses=mine["losses"], reference_losses=ref.losses, worst_leaf=ref.worst,
             nccl_transports=transports, rank_steps=[r["counts"]["steps"] for r in ranks],
             rank_cpu_share=[round(r["host"]["cpu_share"], 3) for r in ranks],
             rank_preempted_per_step=[round(r["host"]["preempted_per_step"], 2) for r in ranks],
             rank_cpus=[r["host"]["cpus"] for r in ranks],
             load_start_end=mine["host"]["load"], gc_by_generation=mine["host"].get("gc"),
             gc_spans=gc_spans,
             collectives_per_step=(counts["collectives"] / steps
                                   if "collectives" in counts and steps else None),
             collective_spans_per_step=spans / steps if spans is not None and steps else None,
             collective_bytes_per_step=(counts["collective_bytes"] / steps
                                        if "collective_bytes" in counts and steps else None),
             **counts)
    return dict(setup_s=mine["setup_s"], e2e={"train_windows_per_s": counts["windows"]
                                               / mine["window_s"]},
                counts=counts, host={"loader_wait_s": mine["loader_wait_s"]},
                trace=mine["trace"], window_s=mine["window_s"],
                memory_peak=mine["memory_peak"], checks=checks, attempted=n_check,
                failed=0)


def _die_with_parent(parent: int):
    """Have the kernel kill this process when its parent dies (Linux's
    PR_SET_PDEATHSIG), and leave at once if the parent is gone already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        sys.exit("h100bench: the rank's parent is gone")


def main(argv=None):
    """A rank other than 0: ``python -m h100bench.drivers.train_dp --workload
    <cell> --seed <n> --seconds <s> --rundir <dir> --parent <pid>
    [--rehearse]`` from the checkout's root, with a launcher's environment."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rundir", required=True)
    ap.add_argument("--parent", type=int, required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    sys.modules.setdefault("tensorflow", None)  # as run.py: TensorBoard's writer imports it
    from .. import run as harness

    _, cell, cfg, mix, _, _, _ = harness.load_cell(args.workload)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cpu") if args.rehearse else torch.device("cuda", rank)
    env = harness.Env(argparse.Namespace(seed=args.seed, seconds=args.seconds, trace=0), cell,
                      cfg, mix, device, args.rehearse)
    out = rank_steps(env, rank, world, args.rundir)
    found = harness.forbidden_modules()
    if found:
        sys.exit(f"h100bench: rank {rank} loaded {found}: the port must not use JAX")
    torch.save({k: out[k] for k in ("batches", "drawn", "counts", "host")},
               os.path.join(args.rundir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
