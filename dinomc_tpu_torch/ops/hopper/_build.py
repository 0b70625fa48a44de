"""Build and load the hand-written CUDA kernels under ``csrc/``.

``nvcc`` compiles each ``csrc/*.cu`` to an object, one process per source,
all started together, and links them into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which is loaded
with ``ctypes``. Headers (``csrc/*.cuh``) are included by the sources, never
compiled on their own. The library is built at first use into
``dinomc_tpu_torch/build/`` and named by a hash of the flags, the sources and
the headers, so an edited file is rebuilt and a stale library is never
loaded. Nothing happens at import time: this module imports on a machine
without CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Kernel launches by name. Each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels its path took.
LAUNCHES: Counter = Counter()


class _Route(threading.local):
    ops = False


_ROUTE = _Route()


@contextlib.contextmanager
def route_ops():
    """Within this block, on this thread, the forward dispatchers (``mha``'s
    two kernels, ``window_attention``, ``fused_mlp``) call their
    ``torch.library`` custom ops (``ops/hopper/custom_ops.py``) instead of
    their autograd Functions, so ``torch.export`` records each kernel as one
    ``dinomc_torch::`` op. The training path never enters it."""
    prev, _ROUTE.ops = _ROUTE.ops, True
    try:
        yield
    finally:
        _ROUTE.ops = prev


def ops_routed() -> bool:
    return _ROUTE.ops


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "dinomc_attn_fwd": [_P] * 5 + [_I] * 4 + [_L] * 3 + [_F, _I, _P, _I],
    "dinomc_attn_bwd_dq": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_F, _I, _P, _I],
    "dinomc_attn_bwd_dkv": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_F, _I, _P, _I],
    "dinomc_photometric": [_P] * 4 + [_I] * 3 + [_F] * 6 + [_P],
    "dinomc_long_attn_fwd": [_P] * 5 + [_I] * 4 + [_L] * 3 + [_F, _P, _I],
    "dinomc_long_attn_dq": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_F, _P, _I],
    "dinomc_long_attn_dkv": [_P] * 8 + [_I] * 4 + [_L] * 3 + [_F, _P, _I],
    "dinomc_win_attn_fwd": [_P] * 6 + [_I] * 5 + [_L] * 2 + [_F, _P, _I],
    "dinomc_win_attn_fwd_per_sm": [_I],
    "dinomc_win_attn_bwd": [_P] * 11 + [_I] * 5 + [_L] * 4 + [_F, _P, _I],
    "dinomc_win_attn_bwd_per_sm": [_I],
    "dinomc_wins_attn_fwd": [_P] * 6 + [_I] * 6 + [_L] * 2 + [_F, _P, _I],
    "dinomc_wins_attn_fwd_per_sm": [_I, _I],
    "dinomc_wins_attn_bwd": [_P] * 11 + [_I] * 6 + [_L] * 4 + [_F, _P, _I],
    "dinomc_wins_attn_bwd_per_sm": [_I, _I],
    "dinomc_fused_mlp": [_P] * 6 + [_I] * 4 + [_P, _I],
}


def _sources() -> list:
    """The translation units nvcc compiles."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _hashed_files() -> list:
    """Everything the library is built from: sources and the headers they
    include."""
    return _sources() + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels (dinomc_tpu_torch/csrc) are built from source at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdinomc_kernels_{h.hexdigest()[:16]}.so"


def compile_commands(nvcc: str, obj_dir: Path) -> list:
    """One ``nvcc -c`` command per source, each writing ``obj_dir/<stem>.o``."""
    return [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj_dir / f"{src.stem}.o")]
            for src in _sources()]


def link_command(nvcc: str, obj_dir: Path, out: Path) -> list:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
            *(str(obj_dir / f"{src.stem}.o") for src in _sources())]


def _run_all(cmds: list) -> None:
    """Run the commands in parallel; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"{' '.join(c)}\n{o}" for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> tuple:
    """Compile the kernels if this exact source set has no library yet.
    Returns (path, seconds spent compiling; 0.0 when already built)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    nvcc = _nvcc()
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    obj_dir = path.with_suffix(f".{os.getpid()}.obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        _run_all(compile_commands(nvcc, obj_dir))
        _run_all([link_command(nvcc, obj_dir, tmp)])
        os.replace(tmp, path)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return path, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# A C entry point returns this plus the driver's CUresult when it could not
# encode a TMA tensor map (csrc/hopper_attn.cuh, MAP_ERROR).
MAP_ERROR = 10000


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launches."""
    if err >= MAP_ERROR:
        raise RuntimeError(f"{what}: encoding a TMA tensor map failed, CUresult {err - MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{name}: kernel takes CUDA tensors (got {t.device}); the plain "
                "version serves CPU tensors only"
            )
