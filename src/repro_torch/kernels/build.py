"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  Nothing
is built when a module is imported: the first CUDA launch calls
:func:`load`, which builds whatever is missing.  Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads in milliseconds.  The ``ptxas`` report (registers,
spills) is kept beside each library as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
# C signatures per source: every pointer and the stream are c_void_p, so
# ctypes never truncates a 64-bit address to an int.
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "bitplane": {
        # c, scale, n, nwords, nbits, out, stream
        "bitplane_encode": (_P, _D, _LL, _LL, _I, _P, _P),
        # words, shifts, nplanes, nwords, state, mag_out, sign_bytes, scale,
        # vals_out, stream
        "bitplane_decode": (_P, _P, _I, _LL, _P, _P, _P, _D, _P, _P),
        # table (7, B) int64, scales (B,) f64, B, nwords, stream
        "bitplane_decode_batch": (_P, _P, _I, _LL, _P),
    },
    "level_vtotal": {
        # even, odd, rows, m, dtype (0 f32, 1 f64), out, stream
        "hier_level_surplus": (_P, _P, _LL, _LL, _I, _P, _P),
        # vx, vy, vz, ex, ey, ez, n, dtype, val_out, bound_out, stream
        "qoi_vtotal": (_P, _P, _P, _D, _D, _D, _LL, _I, _P, _P, _P),
    },
    "fma": {
        # (pointer or null, value, stride) for a, b and c; n, out, stream
        "fma_rn": (_P, _D, _LL, _P, _D, _LL, _P, _D, _LL, _LL, _P, _P),
    },
    "thomas": {
        # b, factor table, h, pre, n, post, out, stream
        "thomas_solve": (_P, _P, _I, _LL, _LL, _LL, _P, _P),
    },
    "decode_attn": {
        # dtype (0 bf16), hd, group
        "decode_attn_setup": (_I, _I, _I),
        # the address of one decode_attn._Params, stream
        "decode_attn": (_P, _P),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is missing."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns the wall seconds per library built
    (empty when everything was cached); raises on a failed compile."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{out.with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def ptxas_report(name: str) -> str:
    """The compiler's register/spill report for a built library."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with its C
    signatures declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(status: int, fn: str) -> None:
    """Raise when a C entry point reports a CUDA launch error."""
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {status}")
