#!/usr/bin/env python3
"""The control of a stream cell's ``correct``: the plain reference put in the
program's place, computed in the nearest precision below the configuration's
float32 (float32 with TF32 on), its vertices sent through the cell's wire, and
held to the float64 reference by the cell's own comparison on the cell's own
streams. Its numbers set the upper readings of the cell's limits
(``limits/<cell>.json``); the benchmark's runs never run it.

    python3 h100bench/control.py --workload dgrad-stream-i16 --seeds 11 12 13

prints one JSON line a seed and control. The program's own lower-precision path (its
library products in TF32) is the other control: the cell run with
``SDFA_MATMUL_PRECISION=high`` in its environment.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def control_frames(ctrl, schedule, check, lsb: float):
    """The control's frames of each stream under check, through the i16
    wire: round(v / lsb) in float32, clamped, times lsb."""
    import numpy as np

    out = {}
    for k in check:
        clip, speaker = schedule.stream(k)
        v = ctrl.vertices(schedule.clips[clip], speaker).astype(np.float32)
        q = np.clip(np.round(v * np.float32(1.0 / lsb)), -32767, 32767)
        out[k] = list(q.astype(np.float32) * np.float32(lsb))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from h100bench import program, run, weights
    from h100bench.drivers import stream_pool
    from h100bench.generator import StreamSchedule

    _, cell, cfg, mix, _, _, _ = run.load_cell(args.workload)
    hp = program.hparams(cfg)
    tmpl = program.install_template()
    device = torch.device(args.device)
    shapes = program.state_shapes(hp)

    if mix["kind"] == "train":
        return train_control(args, cfg, mix, hp, device)

    env = run.Env(argparse.Namespace(seed=0, seconds=0, trace=0), cell, cfg, mix, device,
                  rehearse=device.type != "cuda")
    for seed in args.seeds:
        state = weights.seeded_state(shapes, seed, device)
        schedule = StreamSchedule(mix, seed, int(hp.audio.sample_rate))
        check = schedule.check_set(int(mix["clients"]), int(mix["check_span"]),
                                   int(mix["check_streams"]))
        ref = stream_pool.reference(env, hp, state, tmpl)
        ctrl = stream_pool.reference(env, hp, state, tmpl, dtype=torch.float32, tf32=True)
        frames = control_frames(ctrl, schedule, check, stream_pool.LSB)
        numbers = stream_pool.compare(ref, schedule, check, frames)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "reference_tf32",
                          "checks": numbers}), flush=True)
        del ref, ctrl, state
        env.free()


def train_control(args, cfg, mix, hp, device):
    """The training cell's controls: the reference's steps in float32 with
    TF32 on, from the same weights over the same first batches of the reader,
    held to the float64 reference's steps by the cell's own comparison; and
    the reference's reader in bfloat16 in the reader's place, held to its
    rebuild in float64."""
    import torch

    from h100bench import run as run_mod
    from h100bench.drivers import train
    from h100bench.reference.reader import Reader, bfloat16_batch, compare as compare_reader
    from h100bench.reference.training import Step

    pairs, n_check = int(mix["batch_pairs"]), int(mix["check_steps"])
    for seed in args.seeds:
        env = run_mod.Env(argparse.Namespace(seed=seed, seconds=0, trace=0), None, cfg, mix,
                          device, rehearse=device.type != "cuda")
        hp_t, _, state, params, reader = train.inputs(env)
        drawn = train.record_items(reader, pairs * n_check)
        batches = []
        for b in reader.raw_batches(int(mix["batch_pairs"])):
            batches.append(b)
            if len(batches) == int(mix["check_steps"]):
                break
        hpd = json.loads(json.dumps(hp_t))
        ctrl = Step(hpd, state, params, device, seed, dtype=torch.float32, tf32=True)
        losses, first = [], None
        for i, b in enumerate(batches):
            loss, grads = ctrl.step(b, i)
            losses.append(loss)
            first = grads if first is None else first
        after = dict(state, **{k: ctrl.net.w[k].detach() for k in params})
        ref = Step(hpd, state, params, device, seed)
        numbers = train.compare(ref, batches, losses, first, state, after, params)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "reference_tf32",
                          "checks": numbers}), flush=True)
        rd = Reader(hpd, hpd["dataset_anime"]["root"])
        items = [drawn[i * pairs:(i + 1) * pairs] for i in range(len(batches))]
        keys = sorted((k for k in batches[0] if k.endswith("_coef")), key=lambda k: ("rotat" in k, k))
        numbers = compare_reader(rd, [bfloat16_batch(rd, it, keys) for it in items], items)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "reader_bfloat16",
                          "checks": numbers}), flush=True)


if __name__ == "__main__":
    main()
