"""Build the CUDA sources under flipped_tpu_torch/csrc/ and load them.

All `csrc/*.cu` files compile, with a plain C interface and no PyTorch
headers, into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<hash>/libflipped_kernels.so csrc/*.cu

The library goes under `build/kernels/` at the repository root, in a
directory named by a hash of the sources and flags, and is built at first
use in a process; later calls (and later processes, while the sources are
unchanged) load the library that is there. Wrappers call its functions
through `ctypes` with pointers from `Tensor.data_ptr()` and the stream from
`torch.cuda.current_stream().cuda_stream`.

A missing `nvcc` or a failed build raises `KernelBuildError` with the
compiler's output: no wrapper falls back to a plain path on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libflipped_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing, or the CUDA sources did not compile."""


class KernelLibrary:
    """The loaded shared library and the log of the nvcc run that built it."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        self.lib.flash_text_fwd.argtypes = (
            [ctypes.c_void_p] * 7                      # q k v gate2 vs out lse
            + [ctypes.c_int] * 5                       # B S H Dh max_feats
            + [ctypes.c_longlong] * 3                  # q/k/v strides b s h
            + [ctypes.c_longlong] * 3                  # out strides b s h
            + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
        self.lib.flash_text_fwd.restype = ctypes.c_int
        self.lib.flash_error_string.argtypes = [ctypes.c_int]
        self.lib.flash_error_string.restype = ctypes.c_char_p

    def error_string(self, code: int) -> str:
        return self.lib.flash_error_string(code).decode()


_LOADED: dict = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = (shutil.which("nvcc")
            or shutil.which("nvcc", path=os.path.join(cuda_home, "bin")))
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of flipped_tpu_torch are built from csrc/ at first use "
            "and need the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=1)
def source_hash() -> str:
    """Hash of the sources and flags, read once per process: the wrappers
    call `build()` on every launch, and the sources do not change under a
    running process."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> KernelLibrary:
    """Compile csrc/*.cu (once per source hash) and load the library."""
    key = source_hash()
    if key in _LOADED and not force:
        return _LOADED[key]
    out_dir = BUILD_ROOT / key
    lib_path = out_dir / LIB_NAME
    log = ""
    if force or not lib_path.exists():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        # build into a temp name and rename: a concurrent loader never sees
        # a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)
        (out_dir / "build.log").write_text(log)
    elif (out_dir / "build.log").exists():
        log = (out_dir / "build.log").read_text()
    _LOADED[key] = KernelLibrary(lib_path, log)
    return _LOADED[key]
