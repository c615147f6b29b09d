"""Streaming-client example of the PyTorch/CUDA port (the counterpart of
``examples/stream_client.py``): feed a wav to a running streaming service
in real-time-sized chunks and receive mesh frames as they are produced.

Start the service first:

    python -m sdfa_tpu_torch serve --load_from runs/xxx/last.ckpt \\
        --template_mesh t.ply --mesh_constraints ids.txt --port 9876 --capacity 8

Then:

    python examples/torch_stream_client.py <clip.wav> [host] [port] [out_dir] [--template t.ply]

Frames arrive while the clip is still being pushed (the pipeline's
lookahead is about 0.32 s); each is written as OBJ if an out_dir is given,
with the faces of ``--template``, else of ``mesh.synthetic_template(0)``
(the service's template must have the same faces).
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav")
    ap.add_argument("host", nargs="?", default="127.0.0.1")
    ap.add_argument("port", nargs="?", type=int, default=9876)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--template", default=None)
    args = ap.parse_args(argv)

    from sdfa_tpu_torch import audio, mesh
    from sdfa_tpu_torch.serve import StreamClient

    # the service consumes samples at the model's rate (the voca configs: 8 kHz)
    sig, sr = audio.load(args.wav, sr=8000)
    sig = audio.rms.normalize(sig.astype(np.float32))
    chunk = sr // 10  # 100 ms pushes, as a live microphone sends them

    faces = None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        faces = (mesh.read_mesh(args.template)[1] if args.template
                 else mesh.synthetic_template(0)[1])

    counts = {"frames": 0, "during_push": 0}
    t0 = time.perf_counter()
    with StreamClient((args.host, args.port)) as client:
        sid = client.open(speaker=0)
        pushing = threading.Event()
        pushing.set()

        def reader():
            # drain frames while the clip is still being pushed (sends and
            # receives ride opposite directions of the socket): this keeps the
            # server's outbox bounded on long clips
            for ts, verts in client.frames(sid):
                counts["frames"] += 1
                if pushing.is_set():
                    counts["during_push"] += 1
                if args.out_dir:
                    mesh.write_obj(os.path.join(args.out_dir, f"{int(ts):07d}.obj"),
                                   verts, faces)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for lo in range(0, len(sig), chunk):
            client.push(sid, sig[lo:lo + chunk])
            time.sleep(chunk / sr)  # real-time pacing
        pushing.clear()
        client.flush(sid)
        t.join()
    n_frames = counts["frames"]
    wall = time.perf_counter() - t0
    clip_s = len(sig) / sr
    print(f"{n_frames} frames for a {clip_s:.2f}s clip in {wall:.2f}s "
          f"(incl. real-time paced pushes; {counts['during_push']} frames "
          f"arrived while still pushing)")
    return {"frames": n_frames, "clip_s": clip_s, "wall_s": wall,
            "during_push": counts["during_push"]}


if __name__ == "__main__":
    main()
