"""Serving example of the PyTorch/CUDA port: wav → 3D face-mesh vertices
through ``AnimationTask.generate_vertices`` (the counterpart of
``examples/serve_vertices.py``). The PCA decode and the deformation solve
run on the card; only vertices come back to the host, one OBJ a frame.

The template is ``--template`` (a .ply or .obj, with ``--mesh_constraints``,
its constrained vertex ids separated by white space), else
``mesh.synthetic_template(0)`` (FLAME's counts). The checkpoint's PCA bases
must be over the template's triangles.

Usage:
    python examples/torch_serve_vertices.py <ckpt_or_trace_dir> <clip.wav> [out_dir]
        [--template t.ply --mesh_constraints ids.txt] [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="a checkpoint, or a trace_model directory")
    ap.add_argument("wav")
    ap.add_argument("out_dir", nargs="?", default="serve_out")
    ap.add_argument("--template", default=None)
    ap.add_argument("--mesh_constraints", default=None)
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)

    import torch

    from sdfa_tpu_torch import api, audio, mesh
    from sdfa_tpu_torch.viewer import frame as frame_mod

    if args.platform == "gpu" and not torch.cuda.is_available():
        raise RuntimeError("--platform gpu: torch sees no CUDA device "
                           "(pass --platform cpu to run on the CPU)")
    device = "cuda" if args.platform == "gpu" else "cpu"
    if args.template:
        frame_mod.set_template_mesh(template_path=args.template,
                                    constraints_path=args.mesh_constraints)
    else:
        frame_mod.set_template_mesh(*mesh.synthetic_template(0))

    if os.path.isdir(args.src):
        task = api.load_traced(args.src, device=device)
    else:
        task = api.load_task(args.src, device=device)
    sr = int(task.hp.audio.sample_rate)
    signal, _ = audio.load(args.wav, sr=sr)
    signal = audio.rms.normalize(
        signal, task.hp.dataset_anime.get("audio_target_db", -24.5))

    tslist, verts = task.generate_vertices(signal, speaker=0)
    print(f"{len(tslist)} frames, verts {verts.shape}")

    os.makedirs(args.out_dir, exist_ok=True)
    _, faces = frame_mod.template()
    for i in range(len(verts)):
        mesh.write_obj(os.path.join(args.out_dir, f"{i:06d}.obj"), verts[i], faces)
    print(f"wrote {len(verts)} obj frames to {args.out_dir}")
    return tslist, verts


if __name__ == "__main__":
    main()
