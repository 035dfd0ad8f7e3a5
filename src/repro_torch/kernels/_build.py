"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
its own shared library with a plain C interface, under ``build/
repro_torch_kernels/`` at the root of the checkout (git-ignored).  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  All missing
libraries are compiled together, one ``nvcc`` process per source.

``BINDINGS`` are C++ files compiled by the host compiler against
PyTorch's headers into Python modules (``binding``), in the same parallel
build: a wrapper whose tensors cost more host time in Python than its
kernel takes on the device makes them there (K1's, ``pairwise_l2_bind``).

Nothing here runs at import time: the CPU tests import every module, on
machines that may have no ``nvcc``.  The first CUDA launch builds what it
needs.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else.  The counts are the process's: the
ranks of a client mesh (``launch/mesh.run_ranks``, threads of one process)
add to the same counts, which then sum over the ranks.  ``on_device`` and ``stream`` are the
wrappers' launch context: the device guard switches the current CUDA device
only when the tensors lie on another one, and ``stream`` is the handle of
PyTorch's current stream on a device, read without building a Stream object.

``FAKE_CALLS`` and ``FAKE_FLOPS`` count the model kernels' calls on fake
tensors (``torch._subclasses.fake_tensor``, the dry run's shapes without
storage): such a call launches nothing, returns outputs of the kernel's
shapes and dtypes, and records its analytic FLOPs and the bytes of its
inputs and outputs (``FAKE_BYTES``) here (``fake_call``), never in
``LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

__all__ = [
    "BINDINGS", "FAKE_BYTES", "FAKE_CALLS", "FAKE_FLOPS", "LAUNCHES", "SOURCES", "binding", "build_all", "check",
    "fake_call", "is_fake", "library", "on_device", "reset_fake_calls",
    "reset_launches", "stream",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
SOURCES = ("pairwise_l2", "gram", "flash_decode", "flash_attention", "wkv6")
BINDINGS = ("pairwise_l2_bind",)
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# C signatures: name -> (restype, argtypes).  Pointers and the stream are
# c_void_p so that ctypes does not cut them to 32 bits.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pairwise_l2": {
        "pairwise_l2_plan": (_I, [_I, _I, ctypes.POINTER(_I)]),
        "pairwise_l2_dists_stats": (_I, [_P, _I, _I, _I, _P, _P, _P, _P]),
        "pairwise_l2_sq_dists": (_I, [_P, _I, _I, _I, _P, _P]),
        "pairwise_l2_error_string": (ctypes.c_char_p, [_I]),
    },
    "gram": {
        "gram_normalized": (_I, [_P, _I, _I, _P, _P, _I, _P, _P]),
        "gram_workspace": (ctypes.c_longlong, [_I, _I, _I]),
        "gram_plain": (_I, [_P, _I, _I, _I, _I, _P, _P, _P]),
        "gram_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_decode": {
        "flash_decode_plan": (_I, [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]),
        "flash_decode": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
        "flash_decode_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_attention": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "wkv6": {
        "wkv6_plan": (_I, [_I, _I, _I, _I]),
        "wkv6_workspace": (ctypes.c_longlong, [_I, _I, _I, _I]),
        "wkv6": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        "wkv6_error_string": (ctypes.c_char_p, [_I]),
    },
}

LAUNCHES: Dict[str, int] = {
    "pairwise_dists_stats": 0, "normalized_gram": 0, "pairwise_sq_dists": 0, "gram": 0,
    "flash_decode": 0, "flash_attention": 0, "wkv6": 0,
}
FAKE_CALLS: Dict[str, int] = {"flash_decode": 0, "wkv6": 0}
FAKE_FLOPS: Dict[str, float] = dict.fromkeys(FAKE_CALLS, 0.0)
FAKE_BYTES: Dict[str, float] = dict.fromkeys(FAKE_CALLS, 0.0)
_LIBS: Dict[str, ctypes.CDLL] = {}
_MODULES: Dict[str, ModuleType] = {}
_CURRENT = contextlib.nullcontext()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def is_fake(x) -> bool:
    """Whether ``x`` is a fake tensor (shape and dtype, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def fake_call(name: str, flops: float, tensors) -> None:
    """Record one call of kernel ``name`` on fake tensors: its FLOPs and the
    bytes of ``tensors`` (its inputs and outputs, each read or written
    once)."""
    FAKE_CALLS[name] += 1
    FAKE_FLOPS[name] += flops
    FAKE_BYTES[name] += sum(t.numel() * t.element_size() for t in tensors)


def reset_fake_calls() -> None:
    for name in FAKE_CALLS:
        FAKE_CALLS[name] = 0
        FAKE_FLOPS[name] = FAKE_BYTES[name] = 0.0


def on_device(device):
    """``torch.cuda.device(device)``, or a no-op context when ``device`` is
    already the current CUDA device (the usual case: the switch and the
    switch back cost more host time than a small kernel's launch)."""
    import torch

    if device.index is None or device.index == torch._C._cuda_getDevice():
        return _CURRENT
    return torch.cuda.device(device)


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on CUDA ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def _target(name: str) -> Path:
    if name in BINDINGS:  # keyed by the source, flags and PyTorch it was built for
        import torch

        digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
        digest.update(" ".join((*CXX_FLAGS, torch.__version__)).encode())
        return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}{sysconfig.get_config_var('EXT_SUFFIX')}"
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    """The compile of ``name``: ``nvcc`` for a kernel source; for a binding,
    the host compiler with PyTorch's and Python's headers and libraries, as
    ``torch.utils.cpp_extension`` gives them."""
    if name not in BINDINGS:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    import torch
    from torch.utils import cpp_extension

    libs = cpp_extension.library_paths()
    return [
        os.environ.get("CXX") or "c++", *CXX_FLAGS,
        *(f"-I{p}" for p in cpp_extension.include_paths()), f"-I{sysconfig.get_paths()['include']}",
        f"-DTORCH_EXTENSION_NAME={name}", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
        "-o", str(out), str(CSRC / f"{name}.cpp"),
        *(f"-L{p}" for p in libs), *(f"-Wl,-rpath,{p}" for p in libs),
        "-lc10", "-ltorch", "-ltorch_cpu", "-ltorch_python",
    ]


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile each of ``names`` (default: every source and binding) whose
    library is missing, all compiler processes started together.  Returns
    each one's compiler output (for a kernel source, ``-Xptxas=-v``'s
    register and shared-memory report); raises with the output of every
    failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = (*SOURCES, *BINDINGS) if names is None else names
    pending = [n for n in names if not _target(n).exists()]
    if not pending:
        return {}
    procs = []
    for name in pending:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        procs.append(
            (name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"compiling {name} failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def binding(name: str) -> ModuleType:
    """The loaded Python module of ``csrc/<name>.cpp``, built on first use."""
    mod = _MODULES.get(name)
    if mod is None:
        import importlib.util

        if not _target(name).exists():
            build_all((name,))
        spec = importlib.util.spec_from_file_location(name, _target(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[name] = mod
    return mod


def check(name: str, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run,
    and a later synchronise would not report them)."""
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
