"""Build and load the CUDA kernels of `zstd_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, `build/zstd_tpu_torch/lib<name>.so` at the repository
root, loaded with ctypes. A library is rebuilt when its source or a shared
header (`csrc/*.cuh`) is newer than it, so the first call on a fresh
checkout builds everything. `build_all()` starts one nvcc per source at
once and waits for all of them.

Every C entry point launches on the stream it is given (`launch` passes
torch.cuda.current_stream(), which is the current device's) and returns
cudaGetLastError(); `launch` raises on anything but 0, and before the call
when a tensor argument is not on the current device. `device_launches`
counts the calls by kernel and device index.
"""

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "zstd_tpu_torch")
NAMES = ("huffman", "sequence", "execute", "xxhash64", "execute_window",
         "parse", "fse_encode", "resolve")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures: (entry point, argtypes)
SIGNATURES = {
    "huffman": ("zt_huffman_lanes",
                [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _LL, _I,
                 _P, _I, _P, _P]),
    "sequence": ("zt_sequence_lanes",
                 [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I,
                  _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                  _I, _P, _P]),
    "execute": ("zt_execute_lanes",
                [_P, _P, _P, _LL, _P, _LL, _P, _P, _I, _I, _P, _LL, _P, _P]),
    "xxhash64": ("zt_xxh64_low32_lanes", [_P, _LL, _I, _P, _P, _P, _P]),
    "execute_window": ("zt_execute_window",
                       [_P, _P, _P, _LL, _P, _LL, _P, _P, _I, _P, _I, _I, _P,
                        _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                        _P, _I, _P]),
    "parse": ("zt_parse_lanes",
              [_P, _LL, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
               _P]),
    "fse_encode": ("zt_fse_encode",
                   [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL, _P,
                    _P]),
    "resolve": ("zt_resolve_frames",
                [_P, _P, _P, _P, _LL, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P,
                 _P, _P, _P]),
}

_fns = {}
# (kernel name, CUDA device index) -> calls made through launch()
device_launches = collections.Counter()


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")]
    deps += glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(lib)


def _start_build(name: str):
    """Start nvcc for one source into a temporary file; returns the job."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, tmp, proc


def _finish_build(job) -> None:
    name, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, lib_path(name))  # atomic: processes building at once agree


def build_all(force: bool = False) -> float:
    """Build every stale kernel library in parallel; returns seconds taken."""
    t0 = time.perf_counter()
    jobs = [_start_build(n) for n in NAMES if force or _stale(n)]
    errors = []
    for job in jobs:
        try:
            _finish_build(job)
        except KernelError as e:
            errors.append(str(e))
    if errors:
        raise KernelError("\n".join(errors))
    return time.perf_counter() - t0


def entry(name: str):
    """The ctypes function of kernel `name`, building its library if stale."""
    fn = _fns.get(name)
    if fn is None:
        if _stale(name):
            _finish_build(_start_build(name))
        lib = ctypes.CDLL(lib_path(name))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def symbol(name: str, sym: str, argtypes: list):
    """Another C function `sym` of kernel `name`'s library (returns int)."""
    entry(name)
    fn = getattr(ctypes.CDLL(lib_path(name)), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Call kernel `name`'s C entry point on the current CUDA stream;
    tensors pass as their data pointers. Raises on a tensor that is not on
    the current device (run under torch.cuda.device of the tensors'), and
    on a failed launch."""
    current = torch.cuda.current_device()
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.index != current:
            raise KernelError(f"{name}: a tensor on {a.device} while the "
                              f"current device is cuda:{current}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = entry(name)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err}")
    device_launches[name, current] += 1


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of rank `ndim` on
    `device` — what every kernel takes and nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
