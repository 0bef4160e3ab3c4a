"""Minimal PLY reader and writer (binary little-endian and ascii).

Counterpart of `icepy4d_tpu/io/ply.py`, numpy only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray | None = None,
              binary: bool = True) -> None:
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    has_color = rgb is not None
    if has_color:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)
        rgb = rgb.reshape(-1, 3)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    header = [
        "ply",
        f"format {fmt} 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if has_color:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(
                    n,
                    dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                )
                rec["xyz"] = xyz
                rec["rgb"] = rgb
                f.write(rec.tobytes())
            else:
                f.write(xyz.astype("<f4").tobytes())
        else:
            for i in range(n):
                row = f"{xyz[i,0]} {xyz[i,1]} {xyz[i,2]}"
                if has_color:
                    row += f" {rgb[i,0]} {rgb[i,1]} {rgb[i,2]}"
                f.write((row + "\n").encode())


def read_ply(path) -> tuple[np.ndarray, np.ndarray | None]:
    """Read vertices (and uchar colors if present) from a PLY file."""
    with open(path, "rb") as f:
        # -- header ---------------------------------------------------------
        line = f.readline().decode().strip()
        if line != "ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                props.append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
            "short": "<i2", "ushort": "<u2", "char": "i1",
        }
        dtype = np.dtype([(name, type_map[t]) for name, t in props])
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n)]
            arr = np.array(
                [[float(v) for v in row[: len(props)]] for row in rows]
            )
            data = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        else:
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
            data = {name: raw[name] for name, _ in props}

    xyz = np.stack(
        [data["x"], data["y"], data["z"]], axis=-1
    ).astype(np.float32)
    rgb = None
    if "red" in data:
        rgb = np.stack(
            [data["red"], data["green"], data["blue"]], axis=-1
        ).astype(np.uint8)
    return xyz, rgb
