"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (pointers, sizes and the stream as arguments;
each entry point returns ``cudaGetLastError()``), loaded with ``ctypes``.
The build runs at first use, from the sources in the checkout only, into
``build/kernels/<key>/`` at the repository root, where ``<key>`` hashes
the sources and the compiler flags — an edited source rebuilds. All
sources compile in parallel, one ``nvcc`` each.
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

from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# guards the ops modules' LAUNCHES counters: the transport's worker threads
# launch the remote tier's kernels concurrently
LAUNCH_LOCK = threading.Lock()
# a kernel's op (``torch.ops.repro_torch.*``) -> the bytes of scratch its
# launch allocates beside its outputs, from the op's arguments: held
# while the op runs in the dry-run's count (``analysis.roofline.OpTally``)
SCRATCH_BYTES: dict = {}


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``:
    a kernel's output has no ``grad_fn``, so without this check a
    gradient would stop at the launch without a word. Serving runs under
    ``torch.no_grad()``; training runs the plain functions."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def is_fake(x) -> bool:
    """Whether ``x`` is a fake tensor: shapes without data (the dry-run,
    ``launch.specs``), which a wrapper hands to its kernel's op, counted
    as the kernel and launching nothing."""
    return isinstance(x, FakeTensor)


def count_launch(counter: dict, name: str) -> None:
    """Add one launch of kernel ``name`` to ``counter``."""
    with LAUNCH_LOCK:
        counter[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / build_key()


def build_all() -> Path:
    """Compile every kernel source that has no library yet, all in
    parallel; raise with the compiler's output if any fails. Each
    library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a half-written one."""
    out_dir = build_dir()
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """Load ``lib<name>.so`` and declare each entry point's argument types
    (``ctypes.c_void_p`` for every pointer and the stream, so no pointer
    is cut to 32 bits); every entry point returns a CUDA error code."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, for the calling thread
    (looked up at every launch, never cached): its raw handle, without
    building the Stream object that ``torch.cuda.current_stream``
    returns, host time on every launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t, fn, *args):
    """``fn(*args)`` with ``t``'s device current; the device is switched
    only where another one is current."""
    import torch
    if t.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(t.device):
        return fn(*args)


def require_cuda(t, name: str, dtypes, ndim: int) -> None:
    """Raise on anything the kernels do not take: device, dtype, rank or
    layout."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
