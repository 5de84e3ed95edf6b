"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface,
``build/torch_kernels/<name>-<hash>.so``. The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so a library is rebuilt
exactly when one of them changes and is reused otherwise. Building happens
at first use, never at import: a machine without ``nvcc`` can import every
module of the package. ``ptxas`` reports each kernel's registers and spills
(``-Xptxas -v``) in the build's log, which is kept beside the library
(``<name>-<hash>.log``) and read back by :func:`build_logs`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent
             / "build" / "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# the C signature of every entry point, by library name
SIGNATURES = {
    "flash_fwd": {
        "tpusched_flash_fwd": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L,
             ctypes.c_float, _I, _I, _P], _I),
    },
    "flash_bwd": {
        "tpusched_flash_bwd_dkdv": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
             ctypes.c_float, _I, _I, _P, _I, _P], _I),
        "tpusched_flash_bwd_dq": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
             ctypes.c_float, _I, _I, _P], _I),
    },
    "decode_attn": {
        "tpusched_decode_attn": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _I, _P], _I),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built from source at first "
                       "use")


def _library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the sources' shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together. Returns nvcc's output by
    source for the libraries it built; raises with it if any build fails."""
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List[tuple] = []
    for name, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failures = {}, []
    for name, cmd, tmp, out, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failures.append(f"$ {' '.join(cmd)}\n{logs[name]}")
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def build_all() -> Dict[str, str]:
    return build(SIGNATURES)


def build_logs() -> Dict[str, str]:
    """nvcc's output for every library of the current sources that is
    built, whether this process built it or an earlier one did."""
    logs = {}
    for name in SIGNATURES:
        log = _library_path(name).with_suffix(".log")
        if log.exists():
            logs[name] = log.read_text()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with ``argtypes``/``restype`` declared for every entry point."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
