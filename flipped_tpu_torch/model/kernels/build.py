"""Build the CUDA sources under flipped_tpu_torch/csrc/ and load them.

Each `csrc/*.cu` file compiles, with a plain C interface and no PyTorch
headers, into an object, all nvcc processes started together; one more
nvcc links the objects into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o build/kernels/<hash>/<name>.o csrc/<name>.cu
    nvcc -shared -o build/kernels/<hash>/libflipped_kernels.so *.o

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
        self.lib.flash_text_bwd.argtypes = (
            [ctypes.c_void_p] * 13    # q k v out dout lse gate2 vs dq dk dv
                                      # delta dg2_part
            + [ctypes.c_int] * 5      # B S H Dh max_feats
            + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
        self.lib.flash_text_bwd.restype = ctypes.c_int
        self.lib.flash_stream_fwd.argtypes = (
            [ctypes.c_void_p] * 7                      # q k v gate2 vs out lse
            + [ctypes.c_int] * 7      # B S_q S_k H Dh q_offset max_feats
            + [ctypes.c_longlong] * 9                  # q, k/v, out strides
            + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
        self.lib.flash_stream_fwd.restype = ctypes.c_int
        self.lib.flash_stream_dq.argtypes = (
            [ctypes.c_void_p] * 10    # q k v dout lse delta gate2 vs dq
                                      # dg2_part
            + [ctypes.c_int] * 7      # B S_q S_k H Dh q_offset max_feats
            + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
        self.lib.flash_stream_dq.restype = ctypes.c_int
        self.lib.flash_stream_dkv.argtypes = (
            [ctypes.c_void_p] * 10    # q k v dout lse delta gate2 vs dk dv
            + [ctypes.c_int] * 7      # B S_q S_k H Dh q_offset max_feats
            + [ctypes.c_float, ctypes.c_void_p])       # scale, stream
        self.lib.flash_stream_dkv.restype = ctypes.c_int
        for fn in ("int8_fwd", "int8_grouped_fwd"):
            getattr(self.lib, fn).argtypes = (
                [ctypes.c_void_p] * 6         # x kq scale xq xs out
                + [ctypes.c_int] * 3          # M N K
                + [ctypes.c_void_p])          # stream
            getattr(self.lib, fn).restype = ctypes.c_int
        self.lib.quant_dx.argtypes = (
            [ctypes.c_void_p] * 4             # g kq scale_g dx
            + [ctypes.c_int] * 3              # M N K
            + [ctypes.c_void_p])              # stream
        self.lib.quant_dx.restype = ctypes.c_int
        self.lib.int4_fwd.argtypes = (
            [ctypes.c_void_p] * 6             # x kq4 scale_g xq xs out
            + [ctypes.c_int] * 5              # M N K group act_quant
            + [ctypes.c_void_p])              # stream
        self.lib.int4_fwd.restype = ctypes.c_int
        self.lib.int4_dx.argtypes = (
            [ctypes.c_void_p] * 4             # g kq4 scale_g dx
            + [ctypes.c_int] * 4              # M N K group
            + [ctypes.c_void_p])              # stream
        self.lib.int4_dx.restype = ctypes.c_int
        self.lib.int8_dgrad.argtypes = (
            [ctypes.c_void_p] * 6             # g kq scale gq gsc dx
            + [ctypes.c_int] * 4              # M N K s_mod
            + [ctypes.c_void_p])              # stream
        self.lib.int8_dgrad.restype = ctypes.c_int
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


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise with the log of the first that
    failed, after all have ended (no compiler is left running)."""
    log, failed = "", None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise KernelBuildError(
            f"nvcc failed (exit {code}):\n{' '.join(cmd)}\n{out}")
    return log


def _compile_and_link(nvcc: str, out_dir: Path, lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link. The
    library is written under a temp name and renamed, so a concurrent
    loader never sees a half-written file."""
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / f"{src.stem}.o"),
               str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = _run(procs)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, "-shared", "-o", tmp,
           *[str(out_dir / f"{src.stem}.o")
             for src in sorted(CSRC.glob("*.cu"))]]
    try:
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
    except KernelBuildError:
        os.unlink(tmp)
        raise
    os.replace(tmp, lib_path)
    return log


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
        log = _compile_and_link(nvcc, out_dir, lib_path)
        (out_dir / "build.log").write_text(log)
    elif (out_dir / "build.log").exists():
        log = (out_dir / "build.log").read_text()
    _LOADED[key] = KernelLibrary(lib_path, log)
    return _LOADED[key]
