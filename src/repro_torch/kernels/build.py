"""Build and load the port's CUDA kernel libraries.

Each ``csrc/<name>.cu`` compiles on its own with nvcc into
``lib<name>-<hash>.so`` (a plain C interface, no PyTorch headers, so a
build takes seconds), loaded with ctypes. The hash covers the source,
every shared header (``csrc/*.cuh``) and the flags, so an edited kernel
rebuilds by itself. Builds happen at first
use, into ``build/repro_torch/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``); `build_all` starts one nvcc per source, all
together. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

from repro_torch.runtime import trace

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIBRARIES = ("fused_norm", "attn_stream", "ffn_act", "ffn_act_int8",
             "paged_decode", "qkv_proj")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or put the CUDA toolkit's "
                       "bin directory on PATH")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=LIBRARIES) -> list[str]:
    """Compile every library of ``names`` that is not built yet, one
    nvcc process per source, all started together. Returns the names
    built; raises with nvcc's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    trace.count("kernels.built", len(todo))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with trace.span("setup.kernel_load." + name):
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        trace.count("kernels.loaded")
    return lib


_bound: dict[tuple[str, str], tuple] = {}


def bind(name: str, fn_name: str, argtypes: list) -> tuple:
    """(library, C function) with its argtypes declared, loaded and bound
    once per process: every pointer and the stream are c_void_p, so
    ctypes never narrows an address to a 32-bit int."""
    key = (name, fn_name)
    if key not in _bound:
        lib = load(name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[key] = (lib, fn)
    return _bound[key]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_operands(kernel: str, device, expect: dict) -> None:
    """Raise unless every ``expect`` entry, name -> (tensor, shape,
    dtype), is a contiguous tensor of that shape and dtype on ``device``;
    a None tensor (an absent optional operand) passes."""
    for name, (t, shape, dt) in expect.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape) or t.dtype != dt \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"tensor of shape {tuple(shape)} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def ptr(t) -> int:
    """A tensor's device address, for a ``c_void_p`` argument (ctypes
    converts the int itself; no pointer object is built per call)."""
    return t.data_ptr()


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an int, read on every call
    (a capture runs on a side stream): the pointer that
    ``torch.cuda.current_stream(device).cuda_stream`` holds, without
    building a Stream object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


_DTYPE_CODES: dict = {}


def dtype_code(dtype) -> int:
    if not _DTYPE_CODES:
        import torch
        _DTYPE_CODES.update({torch.float32: 0, torch.bfloat16: 1})
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return code
