"""Minimal PLY reader and writer (ascii and binary_little_endian), numpy only:
the port's own copy of ``poseestimator_tpu/utils/plyio.py``, so template
databases and CAD files written by either package load in the other.
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    """Parsed PLY: vertex properties by name, plus triangle faces if present."""

    vertices: np.ndarray  # (N, 3) float32 xyz
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]
    normals: Optional[np.ndarray] = None  # (N, 3) float32
    faces: Optional[np.ndarray] = None  # (F, 3) int32 triangle indices


def read_ply(path: str) -> PlyData:
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype) or ('list', idx_t, val_t, name)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1]["props"].append(("list", _PLY_TO_NP[parts[2]], _PLY_TO_NP[parts[3]], parts[4]))
            else:
                elements[-1]["props"].append(("scalar", _PLY_TO_NP[parts[1]], parts[2]))

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    out = {}
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for el in elements:
            if all(p[0] == "scalar" for p in el["props"]):
                n_props = len(el["props"])
                arr = np.array(
                    tokens[pos : pos + el["count"] * n_props], dtype=np.float64
                ).reshape(el["count"], n_props)
                pos += el["count"] * n_props
                out[el["name"]] = {p[2]: arr[:, i] for i, p in enumerate(el["props"])}
            else:
                rows = []
                for _ in range(el["count"]):
                    cnt = int(tokens[pos]); pos += 1
                    rows.append([int(t) for t in tokens[pos : pos + cnt]])
                    pos += cnt
                out[el["name"]] = {"list": rows}
    else:
        buf = io.BytesIO(body)
        for el in elements:
            if all(p[0] == "scalar" for p in el["props"]):
                dt = np.dtype([(p[2], "<" + p[1]) for p in el["props"]])
                arr = np.frombuffer(buf.read(dt.itemsize * el["count"]), dtype=dt)
                out[el["name"]] = {name: arr[name] for name in dt.names}
            else:
                rows = []
                for _ in range(el["count"]):
                    # assume single list property per element (standard faces)
                    lp = el["props"][0]
                    idx_dt = np.dtype("<" + lp[1])
                    val_dt = np.dtype("<" + lp[2])
                    cnt = int(np.frombuffer(buf.read(idx_dt.itemsize), idx_dt)[0])
                    rows.append(np.frombuffer(buf.read(val_dt.itemsize * cnt), val_dt).astype(np.int64))
                out[el["name"]] = {"list": rows}

    v = out.get("vertex", {})
    if not all(k in v for k in ("x", "y", "z")):
        raise ValueError(f"{path}: PLY has no vertex x/y/z")
    verts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    colors = None
    if all(k in v for k in ("red", "green", "blue")):
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
        if colors.max() > 1.5:
            colors = colors / 255.0
    normals = None
    if all(k in v for k in ("nx", "ny", "nz")):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    faces = None
    if "face" in out and out["face"].get("list"):
        rows = out["face"]["list"]
        tri = []
        for r in rows:
            r = list(r)
            # fan-triangulate polygons
            for k in range(1, len(r) - 1):
                tri.append([r[0], r[k], r[k + 1]])
        faces = np.asarray(tri, np.int32) if tri else None
    return PlyData(vertices=verts, colors=colors, normals=normals, faces=faces)


def write_ply(
    path: str,
    vertices: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    n = len(vertices)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = None
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        cols = np.clip(np.asarray(colors, np.float64) * 255.0, 0, 255).astype(np.uint8)
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              f"element vertex {n}"]
    type_names = {"f4": "float", "u1": "uchar"}
    for name, t in props:
        header.append(f"property {type_names[t]} {name}")
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    dt = np.dtype([(name, "<" + t) for name, t in props])
    rec = np.empty(n, dtype=dt)
    rec["x"], rec["y"], rec["z"] = vertices.T
    if normals is not None:
        nrm = np.asarray(normals, np.float32).reshape(-1, 3)
        rec["nx"], rec["ny"], rec["nz"] = nrm.T
    if cols is not None:
        rec["red"], rec["green"], rec["blue"] = cols.T

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
            if faces is not None:
                fc = np.asarray(faces, np.int32).reshape(-1, 3)
                fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
                frec = np.empty(len(fc), fdt)
                frec["n"] = 3
                frec["a"], frec["b"], frec["c"] = fc.T
                f.write(frec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(x) for x in row) + "\n").encode("ascii"))
            if faces is not None:
                for a, b, c in np.asarray(faces, np.int64).reshape(-1, 3):
                    f.write(f"3 {a} {b} {c}\n".encode("ascii"))
