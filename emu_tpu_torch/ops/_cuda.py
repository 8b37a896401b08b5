"""Build and load the port's CUDA kernels.

Every `.cu` file under `emu_tpu_torch/csrc/` is compiled by its own `nvcc`
for Hopper (`sm_90a`), all of them at once, and the objects are linked into
ONE shared library with a plain C interface, loaded with `ctypes`. The library is built at first use into
`build/emu_tpu_torch/<hash>/` at the root of the checkout, keyed by a hash
of the sources and flags, so an edited kernel rebuilds and an unchanged one
loads in milliseconds. Nothing here runs at import time: this module is
imported on machines with no GPU and no `nvcc`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emu_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "emu_attention_fwd": [_P] * 8 + [_L] * 12 + [_I] * 6 + [_F, _I, _P],
    "emu_batched_mha_fwd": [_P] * 4 + [_L] * 12 + [_I] * 4 + [_F, _P],
    "emu_batched_mha_smem": [_I],
    "emu_attention_bwd_dq": [_P] * 12 + [_I] * 6 + [_F, _I, _P],
    "emu_attention_bwd_dkv": [_P] * 12 + [_I] * 6 + [_F, _I, _P],
    "emu_attention_bwd_smem": [_I, _I],
    "emu_fused_mlp_fwd": [_P] * 13 + [_I] * 5 + [_F, _I, _I, _P],
    "emu_fused_dense_fwd": [_P] * 9 + [_I] * 6 + [_F, _P],
    "emu_fused_dense_smem": [],
    "emu_fused_mlp_w8a8_fwd": [_P] * 9 + [_I, _I, _F] + [_P] * 6 + [_I] * 6
                              + [_P],
    "emu_w8a8_smem": [],
    "emu_w8a8_fc1_clusters": [_I],
    "emu_w4a8_splits": [_I] * 4,
    "emu_w4a8_smem": [_I],
    "emu_attention_smem": [_I],
    "emu_matmul_q4_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "emu_fused_swiglu_q4_fwd": [_P] * 11 + [_I] * 6 + [_F] + [_I] * 5
                               + [_P],
    "emu_wd_smem": [_I] * 4,
    "emu_add_rmsnorm_fwd": [_P] * 6 + [_I] * 4 + [_F, _P],
    "emu_add_rmsnorm_bwd": [_P] * 8 + [_I] * 6 + [_P],
    "emu_decode_attention_fwd": [_P] + [_L] * 3 + [_P] * 6 + [_L] * 3 + [_P]
                                + [_L] * 3 + [_P] + [_I] * 3 + [_P]
                                + [_I] * 6 + [_L, _F, _I] + [_I] * 3
                                + [_P] * 4,
    "emu_decode_split_smem": [_I] * 3,
}


# An H100's figures the decode plans size their grids with: SMs, and the
# shared memory an SM gives its blocks and one block may take.
H100_SMS = 132
SMEM_PER_SM = 233472
SMEM_PER_BLOCK = 232448


@functools.lru_cache(maxsize=8)
def sm_count(device) -> int:
    """The SM count of a card (the plans' `sms`)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_cpu(t, name: str) -> bool:
    """True for a CPU tensor (the wrapper runs its plain twin); False for a
    CUDA tensor (the wrapper launches its kernel); raises otherwise. (The
    tensor's flags, not its device object: this runs on every call.)"""
    if t.is_cuda:
        return False
    if t.is_cpu:
        return True
    raise ValueError(f"{name}: unsupported device {t.device}")


def kernel_dtype(x) -> bool:
    """The JAX package's dtype rule for its fused kernels (`fused_norm.
    _eligible`, `vit._fused_attn_branch`, `layers._fused_mlp_plan`): 2-byte
    activations (bf16) take the kernel route; fp32 activations take the
    plain composition, as they take XLA there."""
    return x.element_size() <= 2


def records(*tensors) -> bool:
    """Whether autograd records a call on these tensors (None allowed):
    grad is enabled and one of them requires grad."""
    import torch
    if not torch.is_grad_enabled():
        return False
    for t in tensors:
        if t is not None and t.requires_grad:
            return True
    return False


def refuse_grad(name: str, *tensors) -> None:
    """An inference-only kernel's output carries no gradient: refuse to
    launch it where autograd would need one, instead of returning a tensor
    that silently cuts the graph."""
    if records(*tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it under "
            "torch.no_grad() or on inputs that do not require grad")


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libemu_tpu_kernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this exact build exists; returns the .so.
    One nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    ptxas = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_name(f"{out.name}.{tag}")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *(str(obj) for obj, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    if verbose:
        print("".join(logs), end="")
    for obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {status})")


def stream(t) -> int:
    """The raw handle of the current stream on t's card."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def device_of(t):
    """A context making the card of tensor t current for a launch: a no-op
    when it is current already, as it is on a one-card machine."""
    import torch
    if t.get_device() == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def ptr(t) -> int | None:
    """Device pointer of an optional tensor (None → NULL)."""
    return None if t is None else t.data_ptr()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
