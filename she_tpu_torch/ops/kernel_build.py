"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source under she_tpu_torch/csrc/ compiles on first use into a shared
library with a plain C interface, named by a hash of the source, the
headers it includes from csrc/ and the flags, in csrc/build/ (listed in
.gitignore). Nothing is built when the
package is imported. `build` starts one nvcc per source at once and waits
for all of them; `load` builds what is missing and opens it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {"ntt": "ntt.cu", "dim0_int8": "dim0_int8.cu", "simple_pir_matmul": "simple_pir_matmul.cu",
           "ntt_mxu": "ntt_mxu.cu", "key_switch": "key_switch.cu", "behz": "behz.cu",
           "dim0_mac": "dim0_mac.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_bytes(name: str) -> bytes:
    """The source of `name` and every header it includes from csrc/ with a
    quoted #include, recursively, each once."""
    seen, parts = set(), []

    def add(path: Path) -> None:
        if path in seen or not path.is_file():
            return
        seen.add(path)
        data = path.read_bytes()
        parts.append(data)
        for header in _INCLUDE.findall(data):
            add(path.parent / header.decode())

    add(CSRC / SOURCES[name])
    return b"".join(parts)


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, its headers and
    the flags: an edit to a header builds anew."""
    digest = hashlib.sha256(source_bytes(name) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names=None) -> dict[str, float]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns seconds per name (0.0 if cached).
    Raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            tmp,
            out,
        )
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        log_path(name).write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
