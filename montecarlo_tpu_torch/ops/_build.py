"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, which ``ctypes`` loads. The build happens at first
use, from the package's own sources, into ``montecarlo_tpu_torch/_build/``
under a hash of those sources, so an edited source rebuilds and an
unchanged one loads the cached library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
LIB_NAME = "libmc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P_ = ctypes.c_void_p
I_ = ctypes.c_int
LL_ = ctypes.c_longlong

# C entry -> argument types (pointers as c_void_p so ctypes never cuts
# them to 32 bits). Every entry returns its cudaGetLastError() as int.
SIGNATURES = {
    "mc_equity_counts": [I_, P_, I_, LL_, P_, P_, P_],
    "mc_sweep_counts": [I_, P_, P_, I_, LL_, P_, P_, P_],
    "mc_engine_det": [P_, P_, P_, I_, I_, I_, I_, I_, I_, P_],
    "mc_engine_prng": [P_, I_, P_, I_, I_, I_, I_, I_, I_, I_, I_, P_],
    "mc_philox_blocks": [P_, P_, I_, P_],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``;
    raise when neither exists."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(Path(home) / "bin" / "nvcc", os.X_OK):
        return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the kernels unless a build of these sources exists.

    Returns (library path, seconds spent compiling; 0.0 when cached). The
    ptxas report (registers, spills per kernel) lands beside the library
    in ``build.log``."""
    out_dir = BUILD / sources_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outs = [(src, p.communicate()[0], p.returncode) for src, p in procs]
        for src, out, rc in outs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        log = [f"== {src.name}\n{out}" for src, out, _ in outs]
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_lib),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)  # atomic: two concurrent builds both succeed
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
