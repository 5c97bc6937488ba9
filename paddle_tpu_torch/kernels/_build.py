"""Build the CUDA kernels of `csrc/` into one shared library, at first use.

nvcc compiles each `csrc/*.cu` source to an object for `sm_90a` (one
nvcc process per source, all started together), then links them into
`_build/libptt_kernels_<hash>.so`, where the hash covers the sources and
the flags, so an edited source is rebuilt and an unchanged one is not.
The library has a plain C interface and is loaded with ctypes: every
pointer and the stream cross as `ctypes.c_void_p`. Nothing here includes
PyTorch's headers, which keeps a build to seconds.

A failed build raises; there is no fallback. The CPU never gets here:
the wrappers take their plain PyTorch twins for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from paddle_tpu_torch.core.device import is_hopper

__all__ = ["load_library", "build_info"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points in csrc/ (all return a cudaError_t)
_SIGNATURES = {
    "ptt_paged_decode_attention":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "ptt_rms_norm_residual": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "ptt_rope_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_info = {}


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "$CUDA_PATH, /usr/local/cuda and PATH); the "
                           "CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for p in srcs + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(_ARCH + _FLAGS).encode())
    return srcs, digest.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's
    output. Returns the combined compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed (exit "
                               f"{p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _build(srcs, so_path):
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in srcs]
        log = _run_all([[nvcc, *_ARCH, *_FLAGS, "-c", str(s), "-o", o]
                        for s, o in zip(srcs, objs)])
        tmp_so = str(Path(tmp) / so_path.name)
        log += _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp_so, *objs]])
        os.replace(tmp_so, so_path)      # atomic: readers never see half
    return log


def load_library():
    """The kernels' shared library, built from `csrc/` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not is_hopper():
            # an sm_90a binary has no image for any other card
            raise RuntimeError(
                "the CUDA kernels are built for sm_90a (Hopper, compute "
                "capability 9.0); this device is "
                f"{torch.cuda.get_device_capability()}")
        srcs, digest = _sources()
        so_path = _BUILD_DIR / f"libptt_kernels_{digest}.so"
        t0 = time.perf_counter()
        log = ""
        built = not so_path.exists()
        if built:
            log = _build(srcs, so_path)
        lib = ctypes.CDLL(str(so_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _info.update(path=str(so_path), built=built, log=log,
                     seconds=time.perf_counter() - t0,
                     sources=[s.name for s in srcs])
        _lib = lib
        return lib


def build_info():
    """What the last `load_library` did: path, whether it compiled,
    seconds, and the compiler's output (-Xptxas -v register counts)."""
    return dict(_info)


def check(status, what):
    """Raise when a launch's cudaError_t code is not 0."""
    if status != 0:
        raise RuntimeError(f"{what}: kernel launch failed with "
                           f"cudaError_t {status}")
