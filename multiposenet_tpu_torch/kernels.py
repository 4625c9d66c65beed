"""Build, load and count the hand-written CUDA kernels in `csrc/`, and
build the host C libraries there.

Each `csrc/<name>.cu` exposes a plain C entry point. On first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`_build/` (ignored by git) and loaded with `ctypes`; `load_all` builds
several sources at once, one nvcc process each. Nothing is compiled when
a module is imported, so the package imports on machines without a CUDA
toolkit. A wrapper adds one to `LAUNCHES[name]` each time it launches
its kernel, and nowhere else, so a run can show which kernels it went
through.

A host library, `csrc/<name>.c` (plain C99, no CUDA), is built the same
way by the system's C compiler (`cc`) on first use of `load_host`; it
is not a GPU kernel and has no launch count.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CC_FLAGS = ("-O2", "-std=c99", "-shared", "-fPIC")
# Host libraries built from more than csrc/<name>.c: the other sources.
HOST_EXTRA_SOURCES = {"jpeg2000": ("jpeg2000_write.c",)}

# Every kernel source in csrc/, by name.
KERNEL_NAMES = ("decode_peaks", "decode_lanes", "decode_generic",
                "kp_tail", "column_topk", "train_update")
# Kernel launches by kernel name since the last reset_launches(), and by
# (kernel name, CUDA device index).
LAUNCHES: dict[str, int] = {}
LAUNCHES_BY_DEVICE: dict[tuple[str, int], int] = {}
# nvcc's report (registers, shared memory, spills) per built kernel.
BUILD_LOGS: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_all(names: list[str]) -> dict[str, Path]:
    """Compile csrc/<name>.cu into _build/lib<name>.so for every name, one
    nvcc process per source, all started together; returns the library
    paths. Each library is written under a temporary name and renamed into
    place, so a concurrent reader never loads a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    try:
        for name in names:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs[name] = (proc, tmp)
        out = {}
        for name, (proc, tmp) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu (exit {proc.returncode})"
                    f":\n{log}")
            BUILD_LOGS[name] = log
            out[name] = BUILD_DIR / f"lib{name}.so"
            os.replace(tmp, out[name])
        return out
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load_all(names: list[str]) -> dict[str, ctypes.CDLL]:
    """The loaded libraries for csrc/<name>.cu, building in parallel those
    not yet loaded in this process."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        if missing:
            for name, path in build_all(missing).items():
                _libs[name] = ctypes.CDLL(str(path))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    return load_all([name])[name]


def build_host(name: str, source: Path | None = None) -> Path:
    """Compile `source` (default csrc/<name>.c, and the sources
    `HOST_EXTRA_SOURCES` names beside it) with `cc` into
    _build/lib<name>.so, written under a temporary name and renamed into
    place; raises RuntimeError with the compiler's log if it fails."""
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("no C compiler: `cc` is not on PATH")
    sources = [source] if source else [CSRC / f"{name}.c"] + [
        CSRC / extra for extra in HOST_EXTRA_SOURCES.get(name, ())]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cc, *CC_FLAGS, "-o", tmp,
                               *map(str, sources)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed on {', '.join(map(str, sources))}"
                               f" (exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        out = BUILD_DIR / f"lib{name}.so"
        os.replace(tmp, out)
        return out
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for csrc/<name>.c, built on first use in
    this process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_host(name)))
        return _libs[name]


def count_launch(name: str, device=None) -> None:
    """One launch of kernel `name` (on `device`, a torch.device)."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    if device is not None:
        key = (name, device.index)
        LAUNCHES_BY_DEVICE[key] = LAUNCHES_BY_DEVICE.get(key, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES_BY_DEVICE.clear()
