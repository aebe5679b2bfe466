"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library under ``ponyc_tpu_torch/_build/`` (listed in ``.gitignore``),
then loaded with ``ctypes``. No PyTorch headers are involved, so a build
takes seconds. The library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale library is never
loaded. A failed build raises; nothing falls back.

A template kernel is compiled together with a generated header: the
fused dispatch (``csrc/fused_dispatch.cu``) with one cohort's
``pony_cohort.h``, the window kernel (``csrc/mega_window.cu``) with one
program's ``pony_world.h`` (both from ``ops/lanecode.py``). The header is
written into a directory of its own beside the library, which the template
includes; the hash covers it, the source and the shared ``csrc/*.cuh``.
Several sources build at once, one compiler process each (`build`). The
templates are compiled with ``-fmad=false`` (never ``--use_fast_math``), so
that their float results round after every operation as torch's eager
kernels do.

The same template also builds with the host C++ compiler (``host=True``),
for the CPU tests.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
FUSED_FLAGS = NVCC_FLAGS + ("-fmad=false",)
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
              "-ffp-contract=off")

_LOADED: Dict[str, ctypes.CDLL] = {}     # library path -> loaded library


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of ponyc_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def host_cxx() -> Optional[str]:
    """The host C++ compiler, or None."""
    for name in ("c++", "g++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    return None


@dataclasses.dataclass
class Job:
    """One library to build: csrc/<name>.cu, with a generated header
    (`header`, text, written as `header_name`) when the source is a
    template; `tag` names the library. `host` builds it with the host C++
    compiler instead."""
    name: str
    header: Optional[str] = None
    tag: Optional[str] = None
    host: bool = False
    header_name: str = "pony_cohort.h"

    @property
    def src(self) -> str:
        return os.path.join(CSRC_DIR, self.name + ".cu")

    @property
    def flags(self):
        if self.host:
            return HOST_FLAGS
        return FUSED_FLAGS if self.header is not None else NVCC_FLAGS

    @functools.cached_property
    def stem(self) -> str:
        with open(self.src, "rb") as f:
            h = hashlib.sha256(f.read())
        for inc in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
            with open(inc, "rb") as f:          # shared headers
                h.update(f.read())
        h.update((self.header or "").encode())
        h.update(" ".join(self.flags).encode())
        kind = "host-" if self.host else ""
        return f"lib{kind}{self.tag or self.name}-{h.hexdigest()[:16]}"

    @property
    def path(self) -> str:
        return os.path.join(BUILD_DIR, self.stem + ".so")

    def command(self, out: str) -> List[str]:
        cc = host_cxx() if self.host else nvcc_path()
        if cc is None:
            raise RuntimeError("no host C++ compiler (c++, g++ or clang++)")
        cmd = [cc, *self.flags]
        if self.header is not None:
            # Each generated header gets a directory of its own, so that
            # builds of several cohorts can run at once.
            inc = os.path.join(BUILD_DIR, self.stem)
            os.makedirs(inc, exist_ok=True)
            with open(os.path.join(inc, self.header_name), "w") as f:
                f.write(self.header)
            cmd += ["-I", inc]
        return cmd + ["-o", out, self.src]


def build(jobs: List[Job], log=None) -> List[ctypes.CDLL]:
    """Build every job not built yet, all compiler processes started
    together, and load each library. A failed build raises (after every
    process has ended). `log`, if given, receives each compiler's output
    (ptxas reports each kernel's registers, spills and shared memory)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running, seen = [], set()
    t0 = time.perf_counter()
    for job in jobs:
        if job.path in seen or job.path in _LOADED \
                or os.path.exists(job.path):
            continue
        seen.add(job.path)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(job.command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((job, tmp, proc))
    failed = []
    for job, tmp, proc in running:
        out, _ = proc.communicate()
        label = f"csrc/{job.name}.cu" + (f" [{job.tag}]" if job.tag else "")
        if log is not None:
            log(f"{'c++' if job.host else 'nvcc'} {label} (done "
                f"{time.perf_counter() - t0:.1f} s after the builds "
                f"started):\n{out.strip()}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{label} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, job.path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    libs = []
    for job in jobs:
        lib = _LOADED.get(job.path)
        if lib is None:
            lib = _LOADED[job.path] = ctypes.CDLL(job.path)
        libs.append(lib)
    return libs


def pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' data pointers (NULL for an empty
    one), for an entry that takes a pointer list."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() if t.numel() else None for t in tensors])


def load(name: str, log=None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built with nvcc on first
    use; a failed build raises."""
    return build([Job(name)], log)[0]
