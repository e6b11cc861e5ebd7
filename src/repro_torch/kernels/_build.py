"""Build and load the CUDA kernels of ``src/repro_torch/csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together, then one link) into a single shared library
with a plain C interface, ``build/repro_torch/librepro_torch_<hash>.so`` at
the repository root. The hash covers the sources and the flags, so an
edited source builds a new library and an unchanged one is reused. The
library is loaded with ``ctypes``; nothing is built or loaded when this
module is imported, only at the first kernel launch (or an explicit
:func:`build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the library's .log beside it
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)

#: C entry point -> argtypes (every entry returns a cudaError_t as int)
SIGNATURES = {
    "rt_rmsnorm": [_P, _P, _P, _LL, _LL, _F, _I, _I, _P],
    "rt_rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _F, _I, _P],
    "rt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _I, _I, _F, _I,
                           _P],
    "rt_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _STRIDES, _I, _I, _F, _I, _P],
    "rt_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _STRIDES,
                        _I, _I, _F, _I, _P],
    "rt_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _STRIDES, _I, _P],
    "rt_wkv6_bwd": [*[_P] * 15, _I, _I, _I, _I, _STRIDES, _I, _P],
    "rt_rglru": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_rglru_bwd": [*[_P] * 8, _I, _I, _I, _I, _I, _P],
    "rt_rglru_blocks_per_sm": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "rt_wkv6_plan": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "rt_wkv6_bwd_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the repro_torch "
            "CUDA kernels are built from source at first use"
        )
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this version of the sources has no library
    yet; returns the library's path. Raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors, logs = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{log}")
            if proc.returncode != 0:
                errors.append(f"--- {src.name} (rc {proc.returncode})\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        out.with_suffix(".log").write_text("\n".join(logs))
        staged = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {res.returncode}):\n{res.stdout}")
        os.replace(staged, out)  # atomic: a concurrent builder sees all or nothing
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        loaded.rt_error_string.argtypes = [ctypes.c_int]
        loaded.rt_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def strides_arg(*strides: int):
    return (ctypes.c_longlong * len(strides))(*strides)


def stream_arg(device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device with an index), without building a ``torch.cuda.Stream``."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code
