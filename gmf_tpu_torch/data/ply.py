"""Minimal PLY point-cloud IO (Open3D-free).

A copy of ``gmf_tpu/data/ply.py`` (NumPy), kept here because the port
imports nothing of the JAX package. The reference reads .ply fragments
through Open3D
(GMF_DGR dataloader/threedmatch_loader.py, GMF_PointDSC demo). This is a
dependency-free reader/writer covering the common cases: ascii and
binary_little_endian, float32/float64 vertex properties (x, y, z first,
extra per-vertex properties like color/normal are returned too).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_TYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file. Returns dict with 'xyz' [N, 3] plus any extra
    per-vertex properties by name."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = "ascii"
        n_vertex = 0
        props = []  # (name, np dtype str)
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise NotImplementedError("list property on vertices")
                props.append((parts[2], _TYPES[parts[1]][0]))

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append([float(x) for x in f.readline().split()])
            arr = np.asarray(rows)
            data = {n: arr[:, i] for i, n in enumerate(names)}
        elif fmt.startswith("binary_little"):
            dtype = np.dtype([(n, "<" + t) for n, t in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex),
                                dtype=dtype, count=n_vertex)
            data = {n: np.asarray(raw[n]) for n in names}
        elif fmt.startswith("binary_big"):
            dtype = np.dtype([(n, ">" + t) for n, t in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex),
                                dtype=dtype, count=n_vertex)
            data = {n: np.asarray(raw[n]) for n in names}
        else:
            raise ValueError(f"unknown ply format {fmt}")

    out = {"xyz": np.stack([data["x"], data["y"], data["z"]],
                           axis=-1).astype(np.float32)}
    for n in names:
        if n not in ("x", "y", "z"):
            out[n] = data[n]
    return out


def write_ply(path: str, xyz: np.ndarray, ascii_fmt: bool = False):
    """Write an [N, 3] cloud as PLY (binary little-endian by default)."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    header = (
        "ply\n"
        + ("format ascii 1.0\n" if ascii_fmt
           else "format binary_little_endian 1.0\n")
        + f"element vertex {n}\n"
        + "property float x\nproperty float y\nproperty float z\n"
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if ascii_fmt:
            for p in xyz:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode("ascii"))
        else:
            f.write(xyz.astype("<f4").tobytes())
