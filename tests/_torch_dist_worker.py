"""One rank of the data-parallel tests, and the parent's launcher of the ranks.

A rank is a fresh interpreter that imports torch and ``sdfa_tpu_torch`` only
(never jax): it joins a gloo group through a ``file://`` rendezvous in the
test's directory (no port to race for), runs the job's tasks and writes its
results with ``torch.save``. The parent (``run_ranks``) joins every rank with
one deadline and kills them all past it, so that a hang fails one test.

    python tests/_torch_dist_worker.py JOB RANK WORLD INIT_FILE OUT
"""

import datetime
import os
import subprocess
import sys
import time

import torch

GROUP_TIMEOUT_S = 60  # a collective that waits longer than this raises in the rank
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(job: dict, world: int, tmp: str, deadline_s: float = 180.0):
    """Start ``world`` ranks on ``job`` (a dict of named tasks, see ``TASKS``)
    and return each rank's results, rank 0 first."""
    os.makedirs(tmp, exist_ok=True)
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    init = os.path.join(tmp, "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log_path = os.path.join(tmp, f"rank{rank}.log")
        with open(log_path, "w") as fp:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job_path, str(rank), str(world),
                 init, os.path.join(tmp, f"rank{rank}.pt")],
                cwd=REPO, env=env, stdout=fp, stderr=subprocess.STDOUT))
        logs.append(log_path)
    end = time.monotonic() + deadline_s
    try:
        for proc in procs:
            proc.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks still running after {deadline_s} s: "
                           + " | ".join(_tail(p) for p in logs))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(rank, proc.returncode, _tail(path))
           for rank, (proc, path) in enumerate(zip(procs, logs)) if proc.returncode]
    if bad:
        raise RuntimeError(f"ranks failed: {bad}")
    return [torch.load(os.path.join(tmp, f"rank{rank}.pt"), weights_only=False)
            for rank in range(world)]


def _tail(path: str, n: int = 3000) -> str:
    with open(path) as fp:
        return fp.read()[-n:]


def _host(metrics):
    return {k: float(v) for k, v in metrics.items()}


def steps_task(task: dict, rank: int) -> dict:
    """``task["batches"]`` global batches, each sharded to this rank's rows and
    stepped through ``Experiment.train_step`` with ``trainer.multihost``."""
    from sdfa_tpu_torch.config import ConfigDict
    from sdfa_tpu_torch.models.sdfa import SpeechDrivenAnimation
    from sdfa_tpu_torch.ops import bilstm_core
    from sdfa_tpu_torch.parallel import shard_batch
    from sdfa_tpu_torch.train import Experiment

    hp = ConfigDict(task["hparams"])
    hp.trainer.set_key("multihost", True)
    model = SpeechDrivenAnimation(*task["model_args"], **task["model_kwargs"])
    exp = Experiment(hp, model, os.path.join(task["log_dir"], f"rank{rank}"), task["device"],
                     seed=task["seed"])
    exp.model.load_state_dict(task["state_dict"])
    bilstm_core.FWD_LAUNCHES = bilstm_core.BWD_LAUNCHES = 0
    metrics = [_host(exp.train_step(shard_batch(exp.mesh, b))) for b in task["batches"]]
    return {"metrics": metrics, "n_devices": exp.n_devices,
            "state_dict": {k: v.cpu() for k, v in exp.model.state_dict().items()},
            "scalers": {n: [float(x) for x in s] for n, s in exp.scalers.items()},
            "k5_launches": (bilstm_core.FWD_LAUNCHES, bilstm_core.BWD_LAUNCHES)}


def train_model_task(task: dict, rank: int) -> dict:
    """``api.train_model`` with ``trainer.multihost``, each rank in a run
    directory of its own; what each wrote and its parameters."""
    from sdfa_tpu_torch import api

    log_dir = os.path.join(task["log_dir"], f"rank{rank}")
    exp = api.train_model(task["config"], log_dir=log_dir, dataset_root=task["dataset_root"],
                          overrides=task["overrides"], max_steps=task["max_steps"],
                          device=task["device"])
    files = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                   for d, _, names in os.walk(log_dir) for f in names)
    return {"steps": exp.step, "epoch": exp.epoch, "n_devices": exp.n_devices, "files": files,
            "state_dict": {k: v.cpu() for k, v in exp.model.state_dict().items()}}


TASKS = {"steps": steps_task, "train_model": train_model_task}


def main(argv):
    job_path, rank, world, init, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = {name: TASKS[task["kind"]](task, rank) for name, task in job.items()}
    finally:
        dist.destroy_process_group()
    torch.save(results, out)


if __name__ == "__main__":
    main(sys.argv[1:])
