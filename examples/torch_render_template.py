"""Renderer example of the PyTorch/CUDA port (the counterpart of
``examples/render_template.py``): renders the template with the software
rasterizer, 512 x 512, and writes a PNG. The template is ``--template`` (a
.ply or .obj), else ``mesh.synthetic_template(0)``.

Usage:
    python examples/torch_render_template.py [--template t.ply] [--out image.png]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--template", default=None)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "template_render_torch.png"))
    args = ap.parse_args(argv)

    import cv2

    from sdfa_tpu_torch import mesh
    from sdfa_tpu_torch.viewer.render import render_mesh

    if args.template:
        verts, faces = mesh.read_mesh(args.template)
    else:
        verts, faces = mesh.synthetic_template(0)[:2]
    img = render_mesh(verts, faces, (512, 512))
    cv2.imwrite(args.out, img[:, :, ::-1])
    print(f"rendered {img.shape} -> {args.out}")
    return img


if __name__ == "__main__":
    main()
