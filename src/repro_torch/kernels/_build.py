"""Build and load the CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each kernel's compile units (``SOURCES``: a source and its own flags) are
compiled by ``nvcc`` into one shared library with a plain C interface,
loaded with ``ctypes``, at first use — never at import, so the package
imports where there is no CUDA toolkit. Libraries go to
``build/repro_torch/`` at the root of the checkout, named by a hash of
their sources and the flags, so an edited source is rebuilt. Every unit
builds in parallel (one ``nvcc -c`` each, all started together); a
library of several units is then linked from their objects.
``swiftkv_decode.cu`` is compiled as five units (``-DSKV_UNIT=0..4``: four
of 16 kernel instances each, and its C entry points), since one unit of
its 64 instances was the build's longest step.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library name -> its compile units: (a source in SRC_DIR, its extra flags)
SOURCES = {"swiftkv_decode": tuple(("swiftkv_decode.cu", (f"-DSKV_UNIT={u}",))
                                   for u in range(5)) + (("swiftkv_decode_mma.cu", ()),),
           "gemv_w4a8": (("gemv_w4a8.cu", ()),)}
KERNELS = tuple(SOURCES)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    units = SOURCES[name]
    src = b"".join((SRC_DIR / f).read_bytes() for f in dict.fromkeys(f for f, _ in units))
    flags = " ".join(NVCC_FLAGS) + repr(units)
    digest = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` not built yet, every source in
    parallel. Returns nvcc's output (register and shared-memory use per
    kernel) by name for what it built; raises with that output if a build
    fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    procs = {}
    for name in todo:
        stem = library_path(name).with_suffix(f".{os.getpid()}")
        for i, (src, flags) in enumerate(SOURCES[name]):
            obj = Path(f"{stem}.{i}.o")
            procs[name, obj] = subprocess.Popen(
                [nvcc, *compile_flags, *flags, "-o", str(obj), str(SRC_DIR / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = {name: "" for name in todo}, set()
    for (name, _), proc in procs.items():
        logs[name] += proc.communicate()[0]
        if proc.returncode != 0:
            failed.add(name)
    for name in todo:
        objs = [str(obj) for n, obj in procs if n == name]
        if name not in failed:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            logs[name] += link.stdout + link.stderr
            if link.returncode != 0:
                failed.add(name)
            else:
                os.replace(tmp, library_path(name))   # atomic: no half-written .so
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(sorted(failed)) + ":\n" +
                           "\n".join(logs[n] for n in sorted(failed)))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
