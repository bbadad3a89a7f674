"""Build and load the port's CUDA kernels.

Every `handsonvlm_torch/csrc/*.cu` is compiled at first use by `nvcc` for
Hopper (`sm_90a`), one `nvcc` process per source, all started together,
and the objects are linked into one shared library with a plain C
interface, which is loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). The library lands in `build/handsonvlm_torch/` at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file.

There is no fallback: a missing `nvcc` or a failed build raises
`KernelBuildError`, and a C entry point that returns a CUDA error makes
`check` raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "handsonvlm_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--resource-usage",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "hv_decode_attention_stacked": (
        [_P] * 7 + [_I] * 11 + [_F, _P], _I),
    "hv_decode_attention_stacked_q": (
        [_P] * 9 + [_I] * 11 + [_F, _P], _I),
    "hv_decode_attention": ([_P] * 5 + [_I] * 8 + [_F, _P], _I),
    "hv_flash_attention_fwd": (
        [_P] * 6 + [_I] * 7 + [ctypes.c_int64] * 6 + [_I, _I, _F, _P], _I),
    "hv_flash_attention_bwd": (
        [_P] * 11 + [_I] * 7 + [ctypes.c_int64] * 6 + [_I, _I, _F, _I, _P], _I),
    "hv_gather_cache_blocks": ([_P, _P] + [_I] * 4 + [ctypes.c_int64] * 3 + [_I, _I, _P], _I),
    "hv_int4_gemv": ([_P] * 4 + [_I] * 9 + [_P], _I),
    "hv_int8_matmul": ([_P] * 5 + [_I] * 9 + [_P], _I),
    "hv_int4_prefill": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "hv_int4_transpose": ([_P] * 6 + [_I] * 9 + [_P], _I),
    "hv_vit_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _P], _I),
    "hv_qlora_fwd": ([_P] * 9 + [_I] * 7 + [_P], _I),
    "hv_qlora_bwd": ([_P] * 9 + [_I] * 7 + [_P], _I),
    "hv_fused_mlp": ([_P] * 10 + [_I] * 11 + [_F, _I, _P], _I),
    "hv_error_string": ([_I], ctypes.c_char_p),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (not on PATH, not at /usr/local/cuda/bin/nvcc): the "
        "handsonvlm_torch CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their shared headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhandsonvlm_torch_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; declare signatures.

    The build log (nvcc's per-kernel register and shared-memory usage and
    the build time) is written beside the library as `<name>.log`."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _build(path: Path) -> None:
    """Compile each source in its own nvcc process (all at once), then
    link the objects into `path`."""
    nvcc = _nvcc()
    work = path.with_name(f"{path.stem}.{os.getpid()}.d")
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as out:
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT)))
    # wait for every nvcc before raising, so a failed source leaves none running
    codes = [proc.wait() for *_, proc in jobs]
    report = [f"{' '.join(cmd)}\n{log.read_text()}" for cmd, _, log, _ in jobs]
    for code, text in zip(codes, report):
        if code != 0:
            raise KernelBuildError(f"nvcc exited {code}:\n{text}")
    compiled = time.perf_counter() - t0
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc link exited {proc.returncode}: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    shutil.rmtree(work, ignore_errors=True)
    path.with_suffix(".log").write_text(
        f"build_seconds={time.perf_counter() - t0:.3f} "
        f"(compile {compiled:.3f}, {len(jobs)} sources in parallel)\n"
        + "\n".join(report) + f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = load_library().hv_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor requires grad: for the kernels
    with no backward (decode and cache ops, which the JAX package never
    differentiates), whose raw-pointer outputs would otherwise cut the
    graph without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward (its kernel serves decoding only): call it under "
            f"torch.no_grad() or with inputs that do not require grad")
