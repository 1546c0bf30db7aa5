"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``) on first use.

Every ``.cu`` source compiles to an object with its own ``nvcc`` (all started
together), the objects link into one shared library with a plain C
interface, and :mod:`ctypes` loads it: no PyTorch headers, so a build takes
seconds.  The library lands in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.

Nothing here runs at import: the first kernel launch on a CUDA tensor
builds.  A machine without ``nvcc`` raises there; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: the plain versions multiply and add separately, so must the kernels
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry points -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "repro_stencil_nd": [_I, _I, _P, _P, _P, _I, _I, _L, _L, _L, _L, _P, _I, _I, _I, _I, _P],
    "repro_stencil7_dot": [_I, _I, _P, _P, _P, _I, _L, _L, _L, _P, _I, _I, _I, _L, _P, _P, _P],
    "repro_update_q_dots": [_I, _P, _P, _P, _P, _P, _P, _P, _L, _L, _P],
    "repro_update_xr_dots": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _P],
    "repro_update_p": [_I, _P, _P, _P, _P, _P, _P, _L, _L, _P],
    "repro_dot_mixed": [_I, _P, _P, _P, _P, _L, _L, _P],
    "repro_update_q_dots_blocks": [_L],
    "repro_update_xr_dots_blocks": [_L],
    "repro_dot_mixed_blocks": [_L],
}

#: right-hand sides one batched launch takes (kMaxBatch of csrc/common.cuh)
MAX_BATCH = 65535

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the CUDA kernels are built from source on first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{source_hash()}.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path.

    The compiler's output, ``-Xptxas -v`` register and spill counts included,
    is kept beside the library as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = BUILD_DIR / f"tmp-{out.stem}-{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp / (src.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in _sources()]
    logs, failed = [], []
    for src, proc in procs:           # wait for every compiler before judging
        text, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / out.name),
         *(str(tmp / (s.stem + ".o")) for s in _sources())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + "\n".join(logs))
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp / out.name, out)   # atomic: a reader never sees half a library
    shutil.rmtree(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}") from None


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw pointer value."""
    return torch.cuda.current_stream(device).cuda_stream
