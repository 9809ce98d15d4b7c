"""The port's file IO (``sparenet_tpu_torch/data/io.py``, ``data/h5.py``,
``native/``) against the JAX package's on the same files: PCD through the
C++ reader and the Python codec bit for bit (binary, ASCII, F8, integer
fields), ``.h5`` both ways against h5py (the JAX package's codec) with the
0.9 read scale, the layouts the reader refuses, ``.npy``, ``.txt`` and
images."""

import importlib
import sys

import h5py
import numpy as np
import pytest

from sparenet_tpu.data import io as jax_io
from sparenet_tpu.native import read_pcd_native as jax_read_pcd_native
from sparenet_tpu_torch import native
from sparenet_tpu_torch.data import h5
from sparenet_tpu_torch.data import io as port_io

def _pcd(path, fields, sizes, types, counts, rows, kind="binary",
         dtype=None):
    """A .pcd file of ``rows`` (a structured array for binary, a 2-D float
    array for ascii)."""
    n = len(rows)
    head = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            f"FIELDS {' '.join(fields)}\nSIZE {' '.join(map(str, sizes))}\n"
            f"TYPE {' '.join(types)}\nCOUNT {' '.join(map(str, counts))}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
            f"DATA {kind}\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if kind == "binary":
            f.write(np.asarray(rows, dtype=dtype).tobytes())
        else:
            for r in rows:
                f.write((" ".join(repr(float(v)) for v in r) + "\n").encode())
    return str(path)


def _cases(tmp_path, rs):
    n = 257
    xyz = (rs.randn(n, 3) * 0.3).astype(np.float32)
    out = {}
    out["binary_f4"] = _pcd(tmp_path / "b4.pcd", "xyz", [4] * 3, "FFF",
                            [1] * 3, xyz.view([("x", "<f4"), ("y", "<f4"),
                                               ("z", "<f4")]).ravel(),
                            dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    rec = np.zeros(n, [("rgb", "<f4"), ("x", "<f8"), ("normal", "<f4", (3,)),
                       ("y", "<f8"), ("i", "<u2"), ("z", "<f8")])
    rec["x"], rec["y"], rec["z"] = (rs.randn(3, n) * 0.3)
    rec["rgb"], rec["i"] = rs.rand(n), rs.randint(0, 999, n)
    out["binary_f8_extra_fields"] = _pcd(
        tmp_path / "b8.pcd", ["rgb", "x", "normal", "y", "i", "z"],
        [4, 8, 4, 8, 2, 8], ["F", "F", "F", "F", "U", "F"], [1, 1, 3, 1, 1, 1],
        rec, dtype=rec.dtype)
    ints = np.zeros(n, [("x", "<i4"), ("y", "<i2"), ("z", "<i4")])
    ints["x"], ints["y"], ints["z"] = rs.randint(-500, 500, (3, n))
    out["binary_integer_fields"] = _pcd(
        tmp_path / "bi.pcd", "xyz", [4, 2, 4], ["I", "I", "I"], [1] * 3, ints,
        dtype=ints.dtype)
    out["ascii"] = _pcd(tmp_path / "a.pcd", "xyz", [4] * 3, "FFF", [1] * 3,
                        rs.randn(n, 3) * 0.3, kind="ascii")
    out["ascii_integer_extra_fields"] = _pcd(
        tmp_path / "ai.pcd", ["i", "x", "y", "z"], [2, 4, 4, 4], "UIII",
        [1] * 4, rs.randint(-99, 99, (n, 4)), kind="ascii")
    port_io.write_pcd(str(tmp_path / "w.pcd"), xyz)
    out["written"] = str(tmp_path / "w.pcd")
    return out


@pytest.fixture(scope="module")
def pcds(tmp_path_factory):
    return _cases(tmp_path_factory.mktemp("pcd"), np.random.RandomState(3))


CASES = ["binary_f4", "binary_f8_extra_fields", "binary_integer_fields",
         "ascii", "ascii_integer_extra_fields", "written"]


@pytest.mark.parametrize("case", CASES)
def test_pcd_readers_match_jax(pcds, case):
    """The Python codec, the C++ reader and IO.get each equal the JAX
    package's bit for bit, dtype included."""
    path = pcds[case]
    pairs = [(port_io.read_pcd(path), jax_io.read_pcd(path)),
             (native.read_pcd_native(path), jax_read_pcd_native(path)),
             (port_io.IO.get(path), jax_io.IO.get(path))]
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape == (257, 3)
        np.testing.assert_array_equal(got, want)


def test_native_reader_gives_zeros_for_binary_integer_fields(pcds):
    """The C++ reader's binary path reads only float fields and gives 0.0
    for integer ones, as the JAX package's does (IO.get takes it); the
    Python codec reads the integers; the ASCII path reads them either
    way."""
    path = pcds["binary_integer_fields"]
    assert not native.read_pcd_native(path).any()
    assert not port_io.IO.get(path).any()
    ints = port_io.read_pcd(path)
    assert np.abs(ints).max() > 100 and np.array_equal(ints, np.round(ints))
    path = pcds["ascii_integer_extra_fields"]
    np.testing.assert_array_equal(native.read_pcd_native(path),
                                  port_io.read_pcd(path).astype(np.float32))


def test_native_reader_raises_where_it_cannot_parse(tmp_path):
    """No fall-back to the Python codec: a file the reader refuses raises."""
    path = tmp_path / "c.pcd"
    path.write_bytes(b"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                     b"COUNT 1 1 1\nPOINTS 3\nDATA binary_compressed\n\0\0")
    with pytest.raises(ValueError, match="c.pcd"):
        port_io.IO.get(str(path))


def test_native_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    broken = tmp_path / "pcloud.cc"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*pcloud.cc"):
        native.build()
    assert not list((tmp_path / "build").iterdir())   # no temporary left


SHAPES = [((16384, 3), np.float32), ((2048, 3), np.float64), ((5,), np.float32),
          ((2, 3, 4), np.float64), ((0, 3), np.float32), ((), np.float32)]


@pytest.mark.parametrize("shape,dtype", SHAPES,
                         ids=[f"{s}-{np.dtype(d).name}" for s, d in SHAPES])
def test_h5_both_ways_against_h5py(tmp_path, shape, dtype):
    """The port reads what h5py writes, h5py reads what the port writes, and
    the port's file is h5py's byte for byte."""
    arr = np.asarray(np.random.RandomState(1).randn(*shape), dtype)
    ref, mine = str(tmp_path / "ref.h5"), str(tmp_path / "mine.h5")
    with h5py.File(ref, "w") as f:
        f.create_dataset("data", data=arr)
    h5.write(mine, arr)
    got = h5.read(ref)
    assert got.dtype == arr.dtype and got.shape == arr.shape
    np.testing.assert_array_equal(got, arr)
    with h5py.File(mine, "r") as f:
        back = f["data"][()]
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    with open(ref, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def test_h5_reads_compact_big_endian_and_continued_headers(tmp_path):
    arr = np.random.RandomState(2).rand(7, 3).astype(np.float32)
    compact, big, attrs = (str(tmp_path / n) for n in ("c.h5", "b.h5", "a.h5"))
    with h5py.File(compact, "w") as f:
        plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        plist.set_layout(h5py.h5d.COMPACT)
        d = h5py.h5d.create(f.id, b"data", h5py.h5t.IEEE_F32LE,
                            h5py.h5s.create_simple(arr.shape), plist)
        d.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)
    with h5py.File(big, "w") as f:
        f.create_dataset("data", data=arr.astype(">f8"))
        f.create_dataset("other", data=arr * 2)
    with h5py.File(attrs, "w") as f:
        d = f.create_dataset("data", data=arr)
        for i in range(40):       # pushes messages into continuation blocks
            d.attrs[f"attribute_{i}"] = np.arange(30)
    for path, dtype in ((compact, "<f4"), (big, ">f8"), (attrs, "<f4")):
        got = h5.read(path)
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("kind,match", [
    ("chunked", "chunked storage"), ("gzip", "filter pipeline"),
    ("latest", "superblock version 3"), ("no_data", "no dataset 'data'"),
    ("integers", "not floating point"), ("text", "no HDF5 signature")])
def test_h5_refuses_other_layouts(tmp_path, kind, match):
    arr = np.random.RandomState(3).rand(6, 3).astype(np.float32)
    path = str(tmp_path / "x.h5")
    if kind == "text":
        with open(path, "w") as f:
            f.write("not hdf5")
    else:
        with h5py.File(path, "w", libver="latest" if kind == "latest"
                       else "earliest") as f:
            kw = {"chunked": dict(chunks=(2, 3)),
                  "gzip": dict(compression="gzip")}.get(kind, {})
            data = np.arange(6) if kind == "integers" else arr
            f.create_dataset("points" if kind == "no_data" else "data",
                             data=data, **kw)
    with pytest.raises(ValueError, match=match):
        h5.read(path)


def test_h5_io_scale_and_put_match_jax(tmp_path):
    """IO.get scales .h5 clouds by 0.9 as the JAX package's (h5py) does, bit
    for bit; IO.put writes the file the JAX package's writes."""
    arr = (np.random.RandomState(4).randn(2048, 3) * 0.4).astype(np.float32)
    jpath, ppath = str(tmp_path / "j.h5"), str(tmp_path / "p.h5")
    jax_io.IO.put(jpath, arr)
    port_io.IO.put(ppath, arr)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    got, want = port_io.IO.get(jpath), jax_io.IO.get(jpath)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr * 0.9)


def test_npy_txt_and_images_match_jax(tmp_path):
    rs = np.random.RandomState(5)
    npy, txt, png = (str(tmp_path / n) for n in ("a.npy", "b.txt", "c.png"))
    np.save(npy, rs.rand(30, 3).astype(np.float32))
    np.savetxt(txt, rs.rand(8, 3))
    for path in (npy, txt):
        got, want = port_io.IO.get(path), jax_io.IO.get(path)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(png, rs.randint(0, 255, (9, 7, 3)).astype(np.uint8))
    np.testing.assert_array_equal(port_io.IO.get(png), jax_io.IO.get(png))
    with pytest.raises(ValueError, match="Unsupported"):
        port_io.IO.get(str(tmp_path / "d.ply"))


def test_images_name_cv2_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="needs cv2"):
        port_io.IO.get(str(tmp_path / "x.png"))
    transforms = importlib.import_module("sparenet_tpu_torch.data.transforms")
    crop = transforms.CenterCrop({"img_size": (4, 4), "crop_size": (6, 6)})
    with pytest.raises(RuntimeError, match="needs cv2"):
        crop(np.zeros((8, 8, 3), np.float32))
