"""CLI: ``python -m sdfa_tpu_torch {train,evaluate,trace,preprocess,synth,serve}``
(counterpart of ``sdfa_tpu/__main__.py``, with the same arguments and
defaults; reference speech_anime/__main__.py:8-49).

Every mode runs on the card unless ``--platform cpu`` asks for the CPU.
``evaluate`` and ``serve`` install the template of ``--template_mesh`` /
``--mesh_constraints`` first (with neither, the one already installed; with
none installed, or a path that does not exist, they fail before the model
loads); ``--mesh_tricorres`` adds triangle correspondences onto the
template (cross-topology retargeting). ``preprocess`` runs the VOCASET
pipeline from ``--source_root`` into ``--dataset_root``; it needs
``--template_mesh`` (the FLAME template, ``mask/non_face.py`` beside its
directory), since there is no default template, and prints one JSON line
with the dataset root and the seconds of each stage.

    python -m sdfa_tpu_torch preprocess --source_root vocaset --dataset_root data \\
        --template_mesh vocaset/template/FLAME_sample.ply --pitch_variants

    python -m sdfa_tpu_torch evaluate --custom_hparams dgrad --load_from run/last.ckpt \\
        --eval_input clip.wav --eval_spk_cond m0 --template_mesh template.ply \\
        --mesh_constraints constraints.txt --no-save_video --output_dir out

Data-parallel training, one process per card (``trainer.multihost``, given as
an hparams override as the JAX CLI takes it; only rank 0 logs at INFO):

    python -m torch.distributed.run --standalone --nproc_per_node 8 -m sdfa_tpu_torch \\
        train --custom_hparams dgrad --dataset_root data \\
        --overrides '{"trainer": {"multihost": true}}'
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("sdfa_tpu_torch")
    parser.add_argument("mode", choices=["train", "evaluate", "trace", "preprocess", "synth",
                                         "serve"])
    parser.add_argument("--custom_hparams", type=str, default=None)
    parser.add_argument("--tag", type=str, default=None)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--load_from", type=str, default=None)
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--eval_input", type=str, default=None)
    parser.add_argument("--eval_spk_cond", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--traced_dump_path", type=str, default=None)
    parser.add_argument("--overrides", type=str, default=None,
                        help="JSON dict merged over hparams")
    parser.add_argument("--max_steps", type=int, default=None)
    # preprocess / synth options
    parser.add_argument("--source_root", type=str, default=None,
                        help="raw VOCASET download root (preprocess)")
    parser.add_argument("--face_type", type=str, default="dgrad_3d")
    parser.add_argument("--pitch_variants", action="store_true",
                        help="also generate the ±2/±4-semitone audio blob variants consumed "
                        "by random_pitch_shift (preprocess)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace of train steps 10-14 into this dir")
    # evaluate options (reference __main__.py:14-33)
    parser.add_argument("--ensembling_ms", type=int, default=None,
                        help="overwrite 'ensembling_ms'")
    parser.add_argument("--save_video", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--export_mesh_frames", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--draw_latent", action="store_true")
    parser.add_argument("--grid_w", type=int, default=512)
    parser.add_argument("--grid_h", type=int, default=512)
    parser.add_argument("--font_size", type=int, default=24)
    parser.add_argument("--overwrite_video", action=argparse.BooleanOptionalAction,
                        default=True)
    # serve options
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9876)
    parser.add_argument("--capacity", type=int, default=8,
                        help="max concurrent live streams (serve)")
    parser.add_argument("--emit_batch", type=int, default=16)
    parser.add_argument("--block_frames", type=int, default=16)
    parser.add_argument("--device_wire", choices=["i16", "f32", "i8d", "coef", "coef16"],
                        default="i16",
                        help="device→host wire format (serve): i16/f32/i8d ship vertices; "
                        "coef/coef16 ship 265 PCA coefficients the client decodes locally "
                        "(streaming.CoefDecoder)")
    parser.add_argument("--no_pipeline", action="store_true",
                        help="disable pipelined ticks (serve)")
    # deformation assets (reference __main__.py:15-17)
    parser.add_argument("--template_mesh", type=str, default=None)
    parser.add_argument("--mesh_constraints", type=str, default=None)
    parser.add_argument("--mesh_tricorres", type=str, default=None)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="run on the card (default) or on the CPU")
    return parser


def _install_template(args):
    from .viewer import frame as frame_mod

    if args.template_mesh or args.mesh_constraints or args.mesh_tricorres:
        frame_mod.set_template_mesh(template_path=args.template_mesh,
                                    constraints_path=args.mesh_constraints,
                                    corres_path=args.mesh_tricorres)
    else:
        frame_mod.get_solver()  # the one installed, else FileNotFoundError


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    import torch

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: torch sees no CUDA device "
                           "(pass --platform cpu to run on the CPU)")
    device = "cuda" if args.platform == "gpu" else "cpu"

    overrides = json.loads(args.overrides) if args.overrides else None
    if args.tag:
        overrides = dict(overrides or {}, tag=args.tag)
    if args.profile_dir:
        overrides = dict(overrides or {})
        overrides["trainer"] = dict(overrides.get("trainer") or {}, profile=dict(
            dir=args.profile_dir, start_step=10, num_steps=5))

    if args.mode == "train":
        from .api import train_model

        return train_model(custom_hparams=args.custom_hparams, log_dir=args.log_dir,
                           load_from=args.load_from, dataset_root=args.dataset_root,
                           overrides=overrides, max_steps=args.max_steps, device=device)
    if args.mode == "evaluate":
        from .api import evaluate_model

        if args.ensembling_ms is not None:
            overrides = dict(overrides or {}, ensembling_ms=args.ensembling_ms)
        _install_template(args)
        return evaluate_model(
            custom_hparams=args.custom_hparams, load_from=args.load_from,
            eval_input=args.eval_input, eval_spk_cond=args.eval_spk_cond,
            output_dir=args.output_dir, dataset_root=args.dataset_root, overrides=overrides,
            device=device, save_video=args.save_video,
            export_mesh_frames=args.export_mesh_frames, draw_latent=args.draw_latent,
            grid_w=args.grid_w, grid_h=args.grid_h, font_size=args.font_size,
            overwrite_video=args.overwrite_video)
    if args.mode == "trace":
        from .api import trace_model

        return trace_model(custom_hparams=args.custom_hparams, load_from=args.load_from,
                           traced_dump_path=args.traced_dump_path,
                           dataset_root=args.dataset_root, overrides=overrides, device=device)
    if args.mode == "synth":
        from .data import synthetic

        root = args.dataset_root or os.path.join(tempfile.gettempdir(), "synth_voca")
        synthetic.generate(root, face_type=args.face_type)
        print(f"synthetic dataset written to {root}")
        return root
    if args.mode == "serve":
        from .api import load_task, load_traced
        from .serve import serve

        if not (args.traced_dump_path or args.load_from):
            parser.error("serve requires --load_from <checkpoint> or "
                         "--traced_dump_path <trace_model dir>")
        _install_template(args)
        if args.traced_dump_path:
            # warm start from a trace_model dump: hparams and weights, no checkpoint
            task = load_traced(args.traced_dump_path, device=device, device_frontend=True,
                               overlap_frontend=True)
        else:
            task = load_task(args.load_from, custom_hparams=args.custom_hparams,
                             dataset_root=args.dataset_root, overrides=overrides, device=device,
                             device_frontend=True, overlap_frontend=True)
        return serve(task, host=args.host, port=args.port, capacity=args.capacity,
                     emit_batch=args.emit_batch, block_frames=args.block_frames,
                     wire=args.device_wire, pipeline=not args.no_pipeline)
    if args.mode == "preprocess":
        from .data.vocaset import preload

        for flag in ("source_root", "dataset_root", "template_mesh"):
            if not getattr(args, flag):
                parser.error(f"preprocess requires --{flag}")
        if not os.path.exists(args.template_mesh):
            raise FileNotFoundError(f"no template mesh at {args.template_mesh}")
        root, seconds = preload.run_pipeline(
            source_root=args.source_root, output_root=args.dataset_root,
            template_path=args.template_mesh, face_type=args.face_type,
            pitch_variants=args.pitch_variants, device=device)
        print(json.dumps({"dataset_root": root, "stage_s": seconds}), flush=True)
        return root
    raise AssertionError(args.mode)  # argparse's choices hold every mode


if __name__ == "__main__":
    # under a launcher only rank 0 logs the run at INFO
    logging.basicConfig(level=logging.INFO if os.environ.get("RANK", "0") == "0"
                        else logging.WARNING, format="[%(levelname)s] %(name)s: %(message)s")
    from .parallel import multihost

    try:
        main()
    finally:
        multihost.shutdown()  # the process group a multihost run joined, in every rank
