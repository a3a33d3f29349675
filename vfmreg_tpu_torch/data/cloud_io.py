"""Dependency-free PCD and PLY point-cloud readers.

Counterpart of `vfmreg_tpu/data/cloud_io.py` (host numpy, no torch). The
reference's dataloaders read xyz (and named scalar) columns of on-disk
clouds through open3d, pyntcloud or plyfile; the layouts are described by
their headers, so these read them directly.

Supported: PCD v0.7 (ascii / binary; binary_compressed is rejected) and PLY
(ascii / binary_little_endian / binary_big_endian), arbitrary named float or
integer properties.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_PCD_TYPES = {
    ("F", 4): np.dtype("<f4"), ("F", 8): np.dtype("<f8"),
    ("I", 1): np.dtype("<i1"), ("I", 2): np.dtype("<i2"), ("I", 4): np.dtype("<i4"),
    ("U", 1): np.dtype("<u1"), ("U", 2): np.dtype("<u2"), ("U", 4): np.dtype("<u4"),
}

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_pcd(path) -> Dict[str, np.ndarray]:
    """PCD file -> {field name: [N] array} (FIELDS/SIZE/TYPE/COUNT header)."""
    raw = Path(path).read_bytes()
    header_end = 0
    lines = []
    for line in raw.split(b"\n"):
        header_end += len(line) + 1
        text = line.decode("ascii", errors="replace").strip()
        if text and not text.startswith("#"):
            lines.append(text)
        if text.startswith("DATA"):
            break
    hdr = {}
    for l in lines:
        parts = l.split(None, 1)
        if len(parts) == 2:
            hdr[parts[0].upper()] = parts[1].split()
    fields = hdr["FIELDS"]
    sizes = [int(s) for s in hdr["SIZE"]]
    types = hdr["TYPE"]
    counts = [int(c) for c in hdr.get("COUNT", ["1"] * len(fields))]
    n = int(hdr["POINTS"][0])
    mode = hdr["DATA"][0]

    names, formats = [], []
    for f, s, t, c in zip(fields, sizes, types, counts):
        base = _PCD_TYPES[(t, s)]
        for ci in range(c):
            names.append(f if c == 1 else f"{f}_{ci}")
            formats.append(base)
    dtype = np.dtype({"names": names, "formats": formats})

    if mode == "ascii":
        body = raw[header_end:].decode("ascii")
        flat = np.array(body.split(), dtype=np.float64)[: n * len(names)]
        flat = flat.reshape(n, len(names))
        return {name: flat[:, i].astype(formats[i]) for i, name in enumerate(names)}
    if mode == "binary":
        arr = np.frombuffer(raw[header_end:], dtype=dtype, count=n)
        return {name: arr[name] for name in names}
    raise ValueError(f"Unsupported PCD DATA mode {mode!r} (binary_compressed not supported)")


def read_pcd_xyz(path) -> np.ndarray:
    cols = read_pcd(path)
    return np.column_stack([cols["x"], cols["y"], cols["z"]]).astype(np.float64)


def _parse_ply_header(raw: bytes) -> Tuple[str, int, List[Tuple[str, str]], int]:
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    fmt, n = None, 0
    props: List[Tuple[str, str]] = []
    in_vertex = False
    for line in raw[:end].decode("ascii").splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[-1], _PLY_TYPES[parts[1]]))
    return fmt, n, props, end


def read_ply(path) -> Dict[str, np.ndarray]:
    """PLY vertex element -> {property name: [N] array}."""
    raw = Path(path).read_bytes()
    fmt, n, props, off = _parse_ply_header(raw)
    names = [p[0] for p in props]
    if fmt == "ascii":
        body = raw[off:].decode("ascii")
        flat = np.array(body.split(), dtype=np.float64)[: n * len(props)]
        flat = flat.reshape(n, len(props))
        return {name: flat[:, i] for i, name in enumerate(names)}
    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, endian + t) for name, t in props])
    arr = np.frombuffer(raw[off:], dtype=dtype, count=n)
    return {name: np.asarray(arr[name]) for name in names}


def read_ply_xyz(path) -> np.ndarray:
    cols = read_ply(path)
    return np.column_stack([cols["x"], cols["y"], cols["z"]]).astype(np.float64)
