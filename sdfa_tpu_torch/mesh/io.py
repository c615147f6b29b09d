"""Mesh I/O (PLY, ascii + binary_little_endian; OBJ) and a synthetic template
(counterpart of ``sdfa_tpu/mesh/io.py``; ``write_obj`` writes the JAX
package's text byte for byte)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}
_NP_CODES = {"b": "i1", "B": "u1", "h": "i2", "H": "u2", "i": "i4",
             "I": "u4", "f": "f4", "d": "f8"}

# FLAME's counts: the flagship model's output dims are 6·9976 and 3·9976
FLAME_COUNTS = (5023, 9976, 1261)  # vertices, triangles, free vertices


def read_ply(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Return (verts (V,3) dtype, faces (F,3) int32)."""
    with open(path, "rb") as fp:
        line = fp.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
        while True:
            line = fp.readline()
            if not line:
                raise ValueError("unexpected EOF in ply header")
            tokens = line.decode("ascii", "ignore").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append((tokens[4], tokens[3], tokens[2]))
                else:
                    elements[-1][2].append((tokens[2], tokens[1], None))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported ply format: {fmt}")

        verts, faces = None, None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [fp.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts = np.array([[float(r[i]) for i in range(3)] for r in rows], dtype=dtype)
                elif name == "face":
                    faces = np.array([[int(x) for x in r[1:4]] for r in rows], np.int32)
            elif name == "vertex":
                dt = np.dtype([(p, "<" + _NP_CODES[_PLY_TYPES[t][0]]) for p, t, _ in props])
                arr = np.frombuffer(fp.read(dt.itemsize * count), dtype=dt)
                verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(dtype)
            elif name == "face":
                if len(props) != 1 or props[0][2] is None:
                    raise ValueError("face element must be one vertex-index list")
                # triangles only: every record is a count of 3 and three indices,
                # so the element reads as fixed-size records (a record with
                # another count stops the read at the first such record)
                dt = np.dtype([("n", "<" + _NP_CODES[_PLY_TYPES[props[0][2]][0]]),
                               ("i", "<" + _NP_CODES[_PLY_TYPES[props[0][1]][0]], (3,))])
                buf = fp.read(dt.itemsize * count)
                if len(buf) != dt.itemsize * count:
                    raise ValueError(f"truncated face element in {path}")
                arr = np.frombuffer(buf, dtype=dt)
                if (arr["n"] != 3).any():
                    raise ValueError("only triangle meshes supported")
                faces = arr["i"].astype(np.int32)
            else:
                fp.read(sum(_PLY_TYPES[t][1] for _, t, _ in props) * count)
        if verts is None:
            raise ValueError("ply has no vertex element")
        return verts, faces


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    verts = np.reshape(np.asarray(verts, np.float32), (-1, 3))
    faces = np.reshape(np.asarray(faces, np.int32), (-1, 3))
    with open(path, "wb") as fp:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        fp.write(header.encode("ascii"))
        fp.write(verts.astype("<f4").tobytes())
        rec = np.empty(len(faces), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
        rec["n"], rec["i"] = 3, faces
        fp.write(rec.tobytes())


def read_obj(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Return (verts (V,3) dtype, faces (F,3) int32) of the ``v`` / ``f`` lines."""
    verts, faces = [], []
    with open(path) as fp:
        for line in fp:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]])
    return np.asarray(verts, dtype=dtype), np.asarray(faces, np.int32)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    verts = np.reshape(np.asarray(verts), (-1, 3))
    faces = np.reshape(np.asarray(faces), (-1, 3))
    with open(path, "w") as fp:
        for v in verts:
            fp.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for f in faces:
            fp.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def read_mesh(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """``read_ply`` or ``read_obj`` by the file's extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path, dtype)
    if ext == ".obj":
        return read_obj(path, dtype)
    raise ValueError(f"unsupported mesh format: {ext}")


def synthetic_template(seed: int = 0, n_major: int = 58, n_minor: int = 86,
                       n_extra: int = 35, n_free: int = 1261):
    """A torus mesh with FLAME's counts at the defaults: (verts (V,3) f64,
    faces (F,3) int64, cnst_ids (V − n_free,) int64).

    The (n_major × n_minor) torus grid gives n_major·n_minor vertices and
    twice as many triangles (58·86 = 4988 and 9976); ``n_extra``
    unreferenced vertices bring the count to 5023. Unreferenced vertices
    are constrained (a free one would make AᵀA singular), and so is every
    grid vertex past the first ``n_free`` in grid order — a band around
    the tube, bounded by constrained rows on both sides. ``seed`` jitters
    the vertex positions."""
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor), indexing="ij")
    u = 2 * np.pi * i.ravel() / n_major
    v = 2 * np.pi * j.ravel() / n_minor
    big, small = 0.09, 0.04  # metres, head-sized
    grid = np.stack([(big + small * np.cos(v)) * np.cos(u),
                     (big + small * np.cos(v)) * np.sin(u),
                     small * np.sin(v)], axis=1)
    grid += rng.normal(0.0, 2e-4, grid.shape)
    extra = rng.uniform(-0.1, 0.1, (n_extra, 3))
    verts = np.concatenate([grid, extra])

    faces = []
    for a in range(n_major):
        for b in range(n_minor):
            v00 = a * n_minor + b
            v01 = a * n_minor + (b + 1) % n_minor
            v10 = ((a + 1) % n_major) * n_minor + b
            v11 = ((a + 1) % n_major) * n_minor + (b + 1) % n_minor
            faces.append((v00, v10, v01))
            faces.append((v01, v10, v11))
    faces = np.asarray(faces, np.int64)
    cnst_ids = np.arange(n_free, len(verts), dtype=np.int64)

    n_grid = n_major * n_minor
    assert len(verts) == n_grid + n_extra and len(faces) == 2 * n_grid
    assert n_free <= n_grid - n_minor, "free band must leave a constrained row"
    if (n_major, n_minor, n_extra, n_free) == (58, 86, 35, 1261):
        assert (len(verts), len(faces), len(verts) - len(cnst_ids)) == FLAME_COUNTS
    return verts, faces, cnst_ids
