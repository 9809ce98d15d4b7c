"""Build and load the port's CUDA kernels.

All sources in ``sparenet_tpu_torch/csrc/*.cu`` are compiled by ``nvcc``,
one process per source, all started together, and linked by one more
``nvcc`` call into one shared library with a plain C interface, loaded with
ctypes. That takes seconds; a build through ``torch.utils.cpp_extension.load``,
whose sources include PyTorch's headers, takes minutes. The library is
built at first use into ``sparenet_tpu_torch/_build/`` (listed in
.gitignore), under a name that hashes the sources, so an edited source is
never served by a stale build. Objects go to a directory of the building
process and the library to a temporary name that is renamed into place, so
concurrent builds need no lock file.

Every wrapper in ``sparenet_tpu_torch.ops`` counts its kernel launches in
``LAUNCHES`` and the calls of its plain PyTorch version in ``PLAIN_CALLS``;
a run can show with them which path it took. Counts that kernels keep on
the card (``DEVICE_COUNTS``, one int64 tensor a device) are read with
``device_count``: "knn_flagged" and "knn_packed_flagged", the kNN queries
of each arm whose shortlist failed its margin test and took the exact-scan
kernel (csrc/knn.cu).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "PLAIN_CALLS", "DEVICE_COUNTS", "BUILD_INFO",
           "reset_counts", "device_counter", "device_count", "build", "lib",
           "check", "stream_of", "compile_command", "nvcc_command"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_TIMEOUT_S = 600

LAUNCHES = {"knn": 0, "gather_max": 0, "expansion": 0, "mds": 0, "nn_idx": 0,
            "emd_bids": 0, "edge_stats_fwd": 0, "edge_stats_bwd": 0, "p2i": 0,
            "p2i_bwd": 0, "knn_packed": 0, "mds_continue": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
# name -> {device: int64 tensor of one element}, added to by kernels
DEVICE_COUNTS: dict = {"knn_flagged": {}, "knn_packed_flagged": {}}
# filled by build(): the command, its seconds and the compiler's -Xptxas -v
# report (registers, shared memory and spills of every kernel)
BUILD_INFO: dict = {}

_LIB = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "spn_error_string": ((_I,), ctypes.c_char_p),
    "spn_knn_scratch_bytes": ((_I, _I, _I, _I, _I), ctypes.c_longlong),
    "spn_knn": ((_P, _P, _I, _I, _I, _I, _P, _P, _P), _I),
    "spn_slice_plan": ((_I,) * 5 + (_P,), _I),
    "spn_gather_partial_rows": ((_I,) * 5, _I),
    "spn_gather_max": ((_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P), _I),
    "spn_expansion_max_points": ((), _I),
    "spn_expansion": ((_P, _I, _I, _I, _P, _P, _P, _P), _I),
    "spn_mds_max_points": ((), _I),
    "spn_mds": ((_P, _P, _I, _I, _I, _I, _I, _P, _P), _I),
    "spn_mds_shape": ((_I, _I, _P), None),
    "spn_mds_floor": ((_P, _P, _I, _I, _I, _I, _I, _P, _P), _I),
    "spn_nn_idx_splits": ((_I, _I, _I), _I),
    "spn_nn_idx": ((_P, _P, _I, _I, _I, _I, _P, _P, _P, _P), _I),
    "spn_emd_bids_scratch": ((_I, _I), ctypes.c_longlong),
    "spn_emd_bids_plan": ((_I, _I, _I, _I, _P), None),
    "spn_emd_bids": ((_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P), _I),
    "spn_edge_stats_route_bytes": ((_I,), _I),
    "spn_edge_stats_fwd": ((_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P), _I),
    "spn_edge_stats_lists": ((_I, _I, _I, _I, _P), _I),
    "spn_edge_stats_bwd": ((_P,) * 8 + (_I,) * 5 + (_P,) * 7, _I),
    "spn_p2i_scratch_ints": ((_I,) * 7, ctypes.c_longlong),
    "spn_p2i_max": ((_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I) + (_P,) * 5, _I),
    "spn_p2i_bwd_scratch_ints": ((_I,) * 7, ctypes.c_longlong),
    "spn_p2i_bwd_plan": ((_I,) * 5 + (_P,), None),
    "spn_p2i_max_backward": ((_P,) * 5 + (_I,) * 4 + (_F,) + (_I,) * 6 + (_P,) * 4, _I),
    "spn_knn_packed": ((_P, _P, _I, _I, _I, _I, _P, _P, _P), _I),
    "spn_knn_dots": ((_P, _P) + (_I,) * 5 + (_P,) * 4, _I),
    "spn_mds_continue_max_points": ((), _I),
    "spn_mds_continue_max_steps": ((), _I),
    "spn_mds_continue_shape": ((_I, _I, _P), None),
    "spn_mds_continue": ((_P, _P, _P, _P) + (_I,) * 5 + (_P, _P), _I),
    "spn_mds_continue_floor": ((_P, _P, _P, _P) + (_I,) * 4 + (_P, _P), _I),
}


def reset_counts() -> None:
    """Set every launch, plain-call and device count to 0."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0
    for per_device in DEVICE_COUNTS.values():
        for t in per_device.values():
            t.zero_()


def device_counter(name: str, device: torch.device) -> torch.Tensor:
    """The card's counter ``name`` on ``device`` (made at first use)."""
    per_device = DEVICE_COUNTS[name]
    if device not in per_device:
        per_device[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return per_device[device]


def device_count(name: str) -> int:
    """The counter ``name`` summed over the devices (synchronises)."""
    return sum(int(t.item()) for t in DEVICE_COUNTS[name].values())


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built")


def compile_command(source: Path, obj: Path) -> list[str]:
    """The nvcc call that compiles one source into a relocatable object."""
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(obj), str(source)]


def nvcc_command(output: Path, objects=()) -> list[str]:
    """The nvcc call that links the objects into the library ``output``."""
    return [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(output),
            *map(str, objects)]


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands concurrently; raise if one fails or times out."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    done = []
    try:
        for c, p in zip(cmds, procs):
            out, err = p.communicate(timeout=NVCC_TIMEOUT_S)
            done.append(subprocess.CompletedProcess(c, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in done:
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {r.returncode}: "
                               f"{' '.join(r.args)}\n{r.stdout[-2000:]}"
                               f"{r.stderr[-6000:]}")
    return done


def build() -> Path:
    """Compile the kernels if this source set has no library yet; returns
    the library's path. Raises if nvcc is missing or fails."""
    path = BUILD_DIR / f"libsparenet_kernels_{_digest()}.so"
    if path.exists():
        BUILD_INFO.setdefault("path", str(path))
        return path
    work = BUILD_DIR / f"obj_{_digest()}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [work / f"{src.stem}.o" for src in _sources()]
    cmds = [compile_command(src, o) for src, o in zip(_sources(), objs)]
    t0 = time.perf_counter()
    try:
        compiled = _run_all(cmds)
        link = nvcc_command(tmp, objs)
        _run_all([link])
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)
    BUILD_INFO.update(path=str(path), seconds=time.perf_counter() - t0,
                      command=[" ".join(c) for c in cmds + [link]],
                      ptxas="".join(r.stderr for r in compiled))
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIB = so
    return _LIB


def check(code: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib().spn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer int."""
    return torch.cuda.current_stream(t.device).cuda_stream
