"""File IO for point clouds by extension (the port's copy of
sparenet_tpu/data/io.py; reference: datasets/io.py:16-80).

``IO.get(path)``: ``.pcd`` through the C++ reader (``native``, float32 read,
returned as float64 as the JAX package returns it), ``.h5`` through the
port's own HDF5 codec (``data/h5.py``) scaled by the reference's 0.9 ("avoid
overflow while gridding", datasets/io.py:62-65), ``.npy``, ``.txt``, and
``.png``/``.jpg`` through ``cv2`` where it is installed (no shipped dataset
reads images; without cv2 they raise). ``IO.put(path, arr)``: ``.pcd``
(binary float32) and ``.h5``. ``read_pcd`` is the pure-Python PCD codec, the
plain version the tests hold the C++ reader to; nothing falls back to it.
"""

from __future__ import annotations

import os

import numpy as np

from . import h5

__all__ = ["IO", "read_pcd", "write_pcd", "H5_READ_SCALE", "require_cv2"]

H5_READ_SCALE = 0.9

_PCD_TYPE = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4",
             ("I", 2): "i2", ("I", 1): "i1", ("U", 4): "u4",
             ("U", 2): "u2", ("U", 1): "u1"}


def require_cv2(what: str):
    """The ``cv2`` module, or a RuntimeError that names it and ``what``
    needed it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} needs cv2 (OpenCV), which is not "
                           f"installed") from e
    return cv2


def read_pcd(file_path: str) -> np.ndarray:
    """Read an uncompressed .pcd file -> [N, 3] float64 (x, y, z fields)."""
    with open(file_path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("latin-1").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_kind = header["DATA"].split()[0]

        dtype_fields = []
        for name, sz, tp, cnt in zip(fields, sizes, types, counts):
            base = _PCD_TYPE[(tp, sz)]
            if cnt == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (cnt,)))
        dt = np.dtype(dtype_fields)

        if data_kind == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n)
            body = np.atleast_2d(body)
            idx = {name: i for i, name in enumerate(fields)}
            pts = body[:, [idx["x"], idx["y"], idx["z"]]]
        elif data_kind == "binary":
            raw = f.read(dt.itemsize * n)
            arr = np.frombuffer(raw, dtype=dt, count=n)
            pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1)
        else:
            raise ValueError(f"Unsupported PCD DATA kind: {data_kind}")
    return np.ascontiguousarray(pts, dtype=np.float64)


def write_pcd(file_path: str, points: np.ndarray) -> None:
    """Write [N, 3] points as a binary .pcd file."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n"
    )
    with open(file_path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(points.astype("<f4").tobytes())


class IO:
    """get/put by extension (datasets/io.py:16-80)."""

    @classmethod
    def get(cls, file_path: str):
        ext = os.path.splitext(file_path)[1].lower()
        if ext in (".png", ".jpg"):
            cv2 = require_cv2(f"reading {file_path}")
            return cv2.imread(file_path, cv2.IMREAD_UNCHANGED) / 255.0
        if ext == ".npy":
            return np.load(file_path)
        if ext == ".pcd":
            from ..native import read_pcd_native
            return read_pcd_native(file_path).astype(np.float64)
        if ext == ".h5":
            return h5.read(file_path) * H5_READ_SCALE
        if ext == ".txt":
            return np.loadtxt(file_path)
        raise ValueError(f"Unsupported file extension: {ext}")

    @classmethod
    def put(cls, file_path: str, content) -> None:
        ext = os.path.splitext(file_path)[1].lower()
        if ext == ".pcd":
            write_pcd(file_path, content)
            return
        if ext == ".h5":
            h5.write(file_path, content)
            return
        raise ValueError(f"Unsupported file extension: {ext}")
