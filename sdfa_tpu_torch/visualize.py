"""Render a preprocessed dataset to QA videos (counterpart of
``sdfa_tpu/visualize.py``).

Reference: dataset_visualize.py — walks the manifest, reads each sentence's
60 fps frames, reconstructs the meshes (``viewer.render_video``: the solve
on the card unless ``device`` says otherwise) and writes one video per
sentence with its audio track. Video needs OpenCV. Run:
``python -m sdfa_tpu_torch.visualize --dataset_root <root>`` with the
template installed by ``--template_mesh`` / ``--mesh_constraints`` for a
dgrad dataset; ``--platform cpu`` solves on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .data import csvio
from .utils import log


def visualize_dataset(
    root: str,
    face_type: str = "dgrad_3d",
    manifest: str = "train.csv",
    out_dir: Optional[str] = None,
    max_items: Optional[int] = 4,
    fps: float = 60.0,
    device="cuda",
):
    from . import viewer

    viewer.video.require_video()
    out_dir = out_dir or os.path.join(root, "video")
    rows = csvio.read_csv(os.path.join(root, manifest))
    if max_items:
        rows = rows[:max_items]
    for row in rows:
        d = str(row["npy_data_path:path"])
        frames = sorted(f for f in os.listdir(d) if f.endswith(".npy") and "lips" not in f)
        data = np.stack([np.load(os.path.join(d, f)) for f in frames])
        tslist = [i * 1000.0 / fps for i in range(len(frames))]
        blob = np.load(d + "_audio.npz")
        name = f"{row['speaker:str']}_{os.path.basename(d)}"
        path = viewer.render_video(
            sources=[{"title": name, face_type: data, "tslist": tslist}],
            video_fps=fps,
            audio_sr=int(blob["sr"]),
            video_path=os.path.join(out_dir, name + ".avi"),
            audio_signal=np.asarray(blob["audio"]),
            device=device,
        )
        log.info(f"wrote {path}")
    return out_dir


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser("sdfa_tpu_torch.visualize")
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--face_type", default="dgrad_3d")
    parser.add_argument("--manifest", default="train.csv")
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--max_items", type=int, default=4)
    parser.add_argument("--fps", type=float, default=60.0)
    parser.add_argument("--template_mesh", default=None,
                        help="the template (.ply / .obj) a dgrad dataset is solved over")
    parser.add_argument("--mesh_constraints", default=None,
                        help="its constrained vertex ids, separated by white space")
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                        help="where the meshes are solved: the card, or the CPU")
    args = parser.parse_args(argv)
    if args.template_mesh:
        from .viewer import frame

        frame.set_template_mesh(template_path=args.template_mesh,
                                constraints_path=args.mesh_constraints)
    return visualize_dataset(args.dataset_root, face_type=args.face_type,
                             manifest=args.manifest, out_dir=args.out_dir,
                             max_items=args.max_items, fps=args.fps,
                             device="cuda" if args.platform == "gpu" else "cpu")


if __name__ == "__main__":
    main()
