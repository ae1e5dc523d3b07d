"""Shared kernel utilities: constants, padding, the device check, and the
build + loader of the hand-written CUDA kernels under ``csrc/``.

The kernels are CUDA C++ for Hopper (``sm_90a``) with a plain C interface.
They are compiled with ``nvcc`` at first use into ``build/kernels/`` at the
repository root (one ``nvcc -c`` per source, all started together, then one
link), keyed on a hash of the sources, and loaded with ``ctypes``. Nothing
here runs at import time: the CPU tests import every module on a machine
with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Union

import torch

I32_MAX = 2 ** 31 - 1

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

# Launches of each hand kernel since the last ``reset_launches()``: counted
# in ``launch`` (the one place a kernel is launched), so a run can show that
# its path went through the kernels.
LAUNCHES = {"rank_batched": 0, "pair_rank": 0, "merge_path_rank": 0,
            "row_rank": 0, "row_merge": 0, "rank": 0, "tablet_gather": 0,
            "segment_sum": 0, "spmv_ell": 0, "spmv_csr": 0,
            "flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pad_to(x: torch.Tensor, multiple: int, axis: int, value):
    """Pad ``x`` along ``axis`` up to the next multiple; returns (padded, n)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis), n


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. A CUDA device with no card raises:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the shared
    library; returns its path. A library built from the same sources is
    reused."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / "libreprotorch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs, errors = [], []
        for src, obj, p in procs:
            out = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / "libreprotorch.so"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs,
                               "-o", str(tmp_lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # tabs, K, N, q, Q, sides (0 left, 1 right, 2 both), out, stream
    "rank_batched": (_P, _I, _I, _P, _I, _I, _P, _P),
    # tr, tc, n_t, qr, qc, n_q, batch, strict, out, stream
    "pair_rank": (_P, _P, _I, _P, _P, _I, _I, _I, _P, _P),
    # ar, ac, n_a, br, bc, n_b, batch, bounds, n_bounds, rank_a, rank_b,
    # stream
    "merge_path_rank": (_P, _P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P),
    # keys, Q, W, out, stream
    "row_rank": (_P, _I, _I, _P, _P),
    # keys, vals, Q, W, out_k, out_v, stream
    "row_merge": (_P, _P, _I, _I, _P, _P, _P),
    # tab, N, q, Q, sides (0 left, 1 right, 2 both), binary, out, stream
    "rank": (_P, _I, _P, _I, _I, _I, _P, _P),
    # cols, vals, start, ends, q, Q, total, out_r, out_c, out_v, stream
    "tablet_gather": (_P,) * 5 + (_I, _I) + (_P,) * 4,
    # ids, vals, N, n_segments, direct, out, stream
    "segment_sum": (_P, _P, _I, _I, _I, _P, _P),
    # cols, vals, R, K, x, C, y, stream
    "spmv_ell": (_P, _P, _I, _I, _P, _I, _P, _P),
    # indptr, R, cols, vals, nnz, x, C, y, carry, cross, stream
    "spmv_csr": (_P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P),
    # q, k, v, o, ws, lse, B, Sq, Sk, H, KV, hd, causal, q_offset, is_bf16,
    # splits, stream
    "flash_attention": (_P,) * 6 + (_I,) * 10 + (_P,),
    # stream: an empty kernel, the launch floor (timed, never counted)
    "launch_floor": (_P,),
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch one kernel through its C entry point on the current stream of
    ``device``; raise on a CUDA error (the entry points return
    ``cudaGetLastError()``)."""
    fn = getattr(_lib if _lib is not None else lib(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:  # launches go to the calling thread's current device
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed with error {err}")
    LAUNCHES[name] += 1


def check_cuda(name: str, *pairs) -> None:
    """Validate what a kernel takes, given as (tensor, dtype) pairs:
    contiguous tensors of those dtypes on one CUDA device."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")

