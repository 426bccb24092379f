"""Build and load the port's Hopper kernels, and count their launches.

The CUDA sources under ``kernels/csrc/`` have a plain C interface. At the
first call that needs a kernel they are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together, then one
link) into one shared library under ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags, and loaded
with ``ctypes``. A later call in the same process, or a later process with
unchanged sources, reuses it. A failed build raises.

``launch(name, fn, *args)`` is the one place a kernel is launched: it calls
the C launcher, raises when the launcher reports a CUDA error, and adds one
to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# no --use_fast_math: the kernels must round like the plain versions
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {
    "rbf_gram": 0, "plan_argmin": 0, "pareto_mask": 0,
    "flash_attention": 0, "ssd_chunks": 0, "int8_quantize": 0, "int8_dequantize": 0,
    "attention_bwd": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64  # element counts: a 3e9-parameter model overflows 32 bits
_F = ctypes.c_float
_SIGNATURES = {
    # x, y, out, b, n, m, d, neg_gamma, device, stream
    "rbf_gram_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    # t, w, k, mask, out, B, G, time_floor, device, stream
    "plan_argmin_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    # t, e, mask, out, B, G, slots (0: all pairs), device, stream
    "pareto_mask_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, o, lse, scratch, scratch elements, b, h, hk, sq, skv, d,
    # is_bf16, scale, causal, window, kv_len, q_offset, splits, device, stream
    "flash_attention_launch": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _F,
                               _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, dout, lse, lse2, delta, dq_acc, dk_acc, dv_acc, dq, dk, dv,
    # b, h, hk, sq, skv, d, scale, causal, window, kv_len, q_offset, device, stream
    "attention_bwd_launch": [_P] * 14 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    # x, dt, a, B, C, y, states, c_decay, chunk_decay, b, h, g, nc, T, p, n,
    # head_slice, device, stream
    "ssd_chunks_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    # x, q, scales, n, nb, device, stream
    "int8_quantize_launch": [_P, _P, _P, _L, _L, _I, _P],
    # q, scales, out, n, device, stream
    "int8_dequantize_launch": [_P, _P, _P, _L, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
BUILD_LOG: List[str] = []  # nvcc's output (-Xptxas -v) of this process's build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the Hopper "
        "kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    for cmd, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG.append(out)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
            )


def build() -> Path:
    """Compile the sources (if this hash is not built yet); returns the .so."""
    lib_path = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(str(obj))
    _run(procs)
    tmp_lib = work / lib_path.name
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           *objs, "-o", str(tmp_lib)]
    _run([(cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    ))])
    os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(name: str, fn_name: str, *args) -> None:
    """Call one C launcher; raise on a CUDA error; count the launch."""
    err = getattr(library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
