"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use by `nvcc` for `sm_90a` into
its own shared library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited source rebuilds.
`build_all` starts one `nvcc` per source, all at once. The compiler's output
(registers, shared memory, spills from `-Xptxas -v`) is kept in
`build/<name>-<hash>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"

_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
# Aw, UW, det, col, part, y, st, scal, work, K, m, nb, off, q_base, n_real, stream
_PANEL = (_I, [_P] * 9 + [_I] * 6 + [_P])
# a panel library: the two panels and its scratch sizes in elements,
# work_elems(K, m, nb) and part_elems(K, m)
_PANEL_LIB = {"panel_f32": _PANEL, "panel_f64": _PANEL,
              "work_elems": (_Z, [_I] * 3), "part_elems": (_Z, [_I] * 2)}
# latrd_v4's panel takes its tile schedule (device pointer), the number of
# blocks, the resident tiles and the cached row blocks per block before the
# stream
_PANEL_V4 = (_I, [_P] * 9 + [_I] * 6 + [_P, _I, _I, _I, _P])
_PANEL_V4_LIB = {"panel_f32": _PANEL_V4, "panel_f64": _PANEL_V4, "ring_slots": (_I, [_I]),
                 "work_elems": (_Z, [_I] * 3), "part_elems": (_Z, [_I] * 2)}
# latrd_v3's panel takes the same arguments; smem_bytes(K, nb, n_res,
# n_cache, n_units, itemsize) is its dynamic shared memory
_PANEL_V3_LIB = dict(_PANEL_V4_LIB, smem_bytes=(_Z, [_I] * 6))
# latrd's panel takes its block count and two caching switches before the
# stream; smem_bytes(K, m, off, nb, n_cta, cache_window, cache_rows, itemsize)
_PANEL_V1 = (_I, [_P] * 9 + [_I] * 9 + [_P])
_PANEL_V1_LIB = {"panel_f32": _PANEL_V1, "panel_f64": _PANEL_V1, "smem_bytes": (_Z, [_I] * 8),
                 "work_elems": (_Z, [_I] * 3), "part_elems": (_Z, [_I] * 2)}
_SYRK = (_I, [_P, _P, _I, _I, _P])  # A, H, R, P, stream
# syrk_geometry(itemsize, P, int out[7]): the launch geometry (ops/syrk.syrk_plan)
_SYRK_GEOMETRY = (_I, [_I, _I, ctypes.POINTER(_I)])
# each source's C entry points, as (result type, argument types); every
# library also exports `error_string(int)`
SIGNATURES = {
    "latrd": _PANEL_V1_LIB,
    "latrd_v4": _PANEL_V4_LIB,
    "latrd_v3": _PANEL_V3_LIB,
    "latrd_v2": _PANEL_LIB,
    "syrk": {"syrk_f32": _SYRK, "syrk_f64": _SYRK, "syrk_geometry": _SYRK_GEOMETRY},
}
SOURCES = tuple(SIGNATURES)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit.")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    so = _target(name)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = open(so.with_suffix(".log"), "w")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, so, log


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one `nvcc` per source in parallel;
    returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = [j for j in (_start(n) for n in names) if j is not None]
    failed = []
    for proc, tmp, so, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{so.name}: nvcc exit {rc}\n{so.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed."""
    if name not in _libs:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]
