"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

nvcc compiles every source (one nvcc per source, all started together) and
links the objects into one shared library with a plain C interface for
``sm_90a``, loaded with ``ctypes``.  The build happens at first use, from
the repository's sources only, into ``build/`` at the repository root, under
a name made from a hash of the sources and flags, so a changed source builds
anew and an unchanged one loads the library already there.  No fast-math:
``__sinf``/``__cosf`` would break the NCO's phase accuracy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

__all__ = ["library", "ptxas_report", "check", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL, _D, _F = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
    ctypes.c_float,
)
# C entry -> argtypes; every entry returns cudaGetLastError() as an int.
# Pointers (and the stream) must be c_void_p: a bare Python int would be
# passed as a 32-bit int and cut.
_SIGNATURES = {
    "dc_ingest_launch": (_P, _I, _LL, _P, _P, _P, _P, _P, _P, _D, _P),
    "mix_cascade_launch": (
        _P, _P, _LL, _LL, _P, _P, _P, _LL, _F, _P, _I, _P, _P, _I, _I, _P,
    ),
}


def _sources() -> list[pathlib.Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"sdr_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use; raises if nvcc
    fails (its output is in the message)."""
    out = _lib_path()
    if not out.exists():
        _BUILD.mkdir(exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = _BUILD / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        report = [proc.communicate()[0] for _, proc in jobs]  # wait for all
        for (obj, proc), text in zip(jobs, report):
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {obj.name}:\n{text}")
        tmp = _BUILD / f"{tag}.tmp.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
            capture_output=True, text=True, check=False,
        )
        for obj, _ in jobs:
            obj.unlink()
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.sdr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sdr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` output for the built library (registers,
    shared memory and spills per kernel)."""
    library()
    return _lib_path().with_suffix(".ptxas.txt").read_text()


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err:
        msg = library().sdr_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
