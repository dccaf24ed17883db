"""Build a kernel's CUDA source into a shared library with nvcc.

``build(name)`` compiles ``kernels/<name>/csrc/<name>.cu`` for Hopper
(``sm_90a``) into ``build/repro_torch/`` at the repository root, keyed by a
hash of the sources in ``csrc/`` (the ``.cu`` and the headers it includes)
and the flags, and returns the library's path. A build that
exists is reused; a new one is written to a temporary name and moved into
place with `os.replace`, so a concurrent or interrupted build never leaves a
partial library under the final name. The temporary name carries the process
and thread, so builds may run in several threads at once. The library exposes a plain C
interface and is loaded with ctypes; its source includes no PyTorch header,
so a build takes seconds.

`ptxas_usage` reads the registers and spills of every kernel from a
build's ``.log`` (nvcc runs with ``-Xptxas -v``).

nvcc is found through ``CUDA_HOME``, then ``PATH``, then the toolkit's
default install prefix ``/usr/local/cuda``. A missing nvcc or a failed
build raises `RuntimeError` with the compiler's output.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"


def find_nvcc() -> str:
    """Path of the CUDA toolkit's nvcc; raises `RuntimeError` if none."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin directory on PATH")


def source_path(name: str) -> Path:
    """The CUDA source of kernel ``name``."""
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def build(name: str) -> Path:
    """Compile kernel ``name`` (if not built yet) and return the path of its
    shared library. The compiler's output (ptxas register and spill report
    included) is kept beside it with the suffix ``.log``."""
    src = source_path(name)
    sources = b"".join(f.name.encode() + f.read_bytes()
                       for f in sorted(src.parent.iterdir()) if f.is_file())
    digest = hashlib.sha256(sources
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f".{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_usage(log: str) -> dict:
    """Per kernel entry of a ``-Xptxas -v`` report: ``{"registers": n,
    "spill_stores": bytes, "spill_loads": bytes}``, keyed by the entry's
    (mangled) name as ptxas prints it."""
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {"registers": None, "spill_stores": None,
                            "spill_loads": None}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[entry]["spill_stores"] = int(m.group(1))
            usage[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
    return usage
