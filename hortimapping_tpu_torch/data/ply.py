"""PLY mesh / point-cloud I/O in numpy, binary little-endian and ASCII
(counterpart of `hortimapping_tpu/data/ply.py`; the two packages read each
other's files equal). Vertex colours are written as uchar and read back in
[0, 1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hortimapping_tpu_torch.data.mesh import PointCloud, TriangleMesh


def write_ply(
    path: str,
    vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    vertices = np.asarray(vertices, np.float32)
    n_v = vertices.shape[0]
    has_color = colors is not None
    if has_color:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(np.asarray(c, np.float64) * 255.0, 0, 255).astype(np.uint8)
    n_f = 0 if faces is None else int(np.asarray(faces).shape[0])

    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header.append(f"element vertex {n_v}")
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header.append(f"element face {n_f}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(n_v, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = vertices
                rec["rgb"] = c
                f.write(rec.tobytes())
            else:
                f.write(vertices.astype("<f4").tobytes())
            if faces is not None:
                fa = np.asarray(faces, "<i4")
                rec = np.zeros(n_f, dtype=[("n", "u1"), ("idx", "<i4", 3)])
                rec["n"] = 3
                rec["idx"] = fa
                f.write(rec.tobytes())
        else:
            for i in range(n_v):
                row = f"{vertices[i,0]} {vertices[i,1]} {vertices[i,2]}"
                if has_color:
                    row += f" {c[i,0]} {c[i,1]} {c[i,2]}"
                f.write((row + "\n").encode())
            if faces is not None:
                for i in range(n_f):
                    fa = faces[i]
                    f.write(f"3 {fa[0]} {fa[1]} {fa[2]}\n".encode())


def write_mesh(path: str, mesh: TriangleMesh, binary: bool = True) -> None:
    write_ply(path, mesh.vertices, mesh.faces, mesh.vertex_colors, binary)


def write_point_cloud(path: str, pcd: PointCloud, binary: bool = True) -> None:
    write_ply(path, pcd.points, None, pcd.colors, binary)


def _parse_header(f) -> Tuple[str, list]:
    fmt = None
    elements = []  # list of (name, count, [(prop_dtype, prop_name) | ("list", ...)])
    cur = None
    while True:
        line = f.readline().decode("ascii", "replace").strip()
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            _, name, count = line.split()
            cur = (name, int(count), [])
            elements.append(cur)
        elif line.startswith("property"):
            parts = line.split()
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur[2].append((parts[1], parts[2]))
        elif line == "end_header":
            break
        elif line == "" and f.peek() == b"":  # type: ignore[attr-defined]
            raise ValueError("truncated PLY header")
    return fmt, elements


_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Read a PLY file -> (vertices, faces | None, colors | None).

    Supports binary_little_endian and ascii, plain vertex properties and a
    single uchar/int face list (the formats this pipeline writes and the
    reference datasets use).
    """
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt, elements = _parse_header(f)

        data = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                if fmt == "ascii":
                    faces = []
                    for _ in range(count):
                        vals = f.readline().split()
                        k = int(vals[0])
                        faces.append([int(v) for v in vals[1 : 1 + k]])
                    data[name] = np.asarray(faces, np.int32)
                else:
                    lp = props[0]
                    cnt_dt = np.dtype(_DTYPES[lp[1]])
                    idx_dt = np.dtype(_DTYPES[lp[2]])
                    # assume uniform triangle lists (rewind-safe fast path)
                    start = f.tell()
                    first_n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                    f.seek(start)
                    rec = np.dtype([("n", cnt_dt), ("idx", idx_dt, first_n)])
                    raw = np.frombuffer(f.read(rec.itemsize * count), rec)
                    data[name] = raw["idx"].astype(np.int32)
            else:
                dt = np.dtype([(p[1], _DTYPES[p[0]]) for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.zeros(count, dt)
                    for ci, p in enumerate(props):
                        arr[p[1]] = np.asarray([r[ci] for r in rows], dtype=_DTYPES[p[0]])
                else:
                    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                data[name] = arr

    verts_rec = data["vertex"]
    vertices = np.stack([verts_rec["x"], verts_rec["y"], verts_rec["z"]], axis=-1)
    vertices = vertices.astype(np.float32)
    colors = None
    if "red" in verts_rec.dtype.names:
        rgb = np.stack([verts_rec["red"], verts_rec["green"], verts_rec["blue"]], axis=-1)
        colors = rgb.astype(np.float32) / 255.0
    faces = data.get("face")
    return vertices, faces, colors


def read_mesh(path: str) -> TriangleMesh:
    v, fcs, c = read_ply(path)
    if fcs is None:
        fcs = np.zeros((0, 3), np.int32)
    return TriangleMesh(v, fcs, c)


def read_point_cloud(path: str) -> PointCloud:
    v, _, c = read_ply(path)
    return PointCloud(v, c)
