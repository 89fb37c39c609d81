"""Build, load and launch the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` expose plain C entry points.  At
first use they are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c``
per source, all started together), linked into one shared library, and
loaded with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited source rebuilds.  The build directory is
``repro_torch/.build`` (override with ``REPRO_TORCH_BUILD_DIR``).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and adds one
to the kernel's launch count.  The counts are how a run shows that its
path went through the kernels.

The same library allocates the 'hmem' value tier (``csrc/host_memory.cu``):
:func:`pinned_empty` gives a tensor in pinned host memory mapped into the
card's address space, and :func:`check_plane` lets the row kernels
(gather_rows, scatter_rows) take such a plane beside key planes on the card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import weakref

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# The argument types of every C entry point: P = pointer, I = int64, i = int,
# f = float.
_SIGNATURES = {
    "hkv_find_scan": "PPPPPPPPPPPPPIIiiP",
    "hkv_find_scan_many": "PIPPPPPPPPPPIIiiP",
    "hkv_upsert_probe": "PPPPPPPPPPPPIiiP",
    "hkv_claim_scan": "PPPPPPPPIP",
    "hkv_scatter_rows": "PPPPIIIiiiP",
    "hkv_gather_rows": "PPPPIIIIiP",
    "hkv_digest_scan": "PPPPPPPPPIP",
    "hkv_sweep_match": "PPPPIiIIP",
    "hkv_update_scan": "PPPPPPPPPPIIiiifffiP",
    "hkv_bucket_stats": "PPPPPIP",
}
# The host-memory calls (no stream): csrc/host_memory.cu.
_HOST_SIGNATURES = {
    "hkv_host_alloc": "PI",
    "hkv_host_free": "P",
    "hkv_host_device_pointer": "PP",
    "hkv_device_attribute": "iiP",
}
_CTYPES = {"P": ctypes.c_void_p, "I": ctypes.c_int64, "i": ctypes.c_int, "f": ctypes.c_float}

launch_counts: collections.Counter = collections.Counter()
build_log: list[str] = []
_lib = None
_lock = threading.Lock()


def reset_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build_dir() -> pathlib.Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(d) if d else CSRC.parent / ".build"


def build() -> pathlib.Path:
    """Compile the sources (if this exact build is not there yet) and
    return the shared library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = build_dir() / f"libhkv_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        for src, p in zip(sources, procs):
            log = p.communicate()[0]
            build_log.append(f"[nvcc {src.name}]\n{log}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib_tmp = pathlib.Path(tmp) / out.name
        r = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(lib_tmp)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{r.stdout}")
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, sig in (*_SIGNATURES.items(), *_HOST_SIGNATURES.items()):
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[c] for c in sig]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ctypes.c_void_p(x.data_ptr())
    return x


def launch(name: str, *args) -> None:
    """Call C entry point `hkv_<name>` on the current stream, raise on a
    launch error, and count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), "hkv_" + name)(*map(_arg, args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError {err}")
    launch_counts[name] += 1


def pinned_empty(shape, dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in pinned host memory, mapped into the
    card's address space (cudaHostAlloc); the memory is freed when the last
    tensor viewing it is."""
    lib = library()
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    ptr = ctypes.c_void_p()
    err = lib.hkv_host_alloc(ctypes.byref(ptr), max(nbytes, 1))
    if err != 0:
        raise RuntimeError(f"cudaHostAlloc of {nbytes} bytes failed: cudaError {err}")
    buf = (ctypes.c_char * max(nbytes, 1)).from_address(ptr.value)
    # the tensor keeps `buf` alive; the allocation dies with it
    weakref.finalize(buf, lib.hkv_host_free, ptr.value).atexit = False
    return torch.frombuffer(buf, dtype=torch.uint8)[:nbytes].view(dtype).view(tuple(shape))


def device_pointer(t: torch.Tensor) -> int:
    """The card's address of a CPU tensor in pinned, mapped host memory
    (raises for any other CPU tensor).  Under unified addressing it is the
    host address itself, which the kernels are then given."""
    dptr = ctypes.c_void_p()
    err = library().hkv_host_device_pointer(ctypes.c_void_p(t.data_ptr()), ctypes.byref(dptr))
    check(err == 0, "a CPU value plane beside CUDA tensors must be pinned host memory mapped "
                    "into the card's address space (value_tier='hmem'); this one is not "
                    f"(cudaError {err})")
    check(dptr.value == t.data_ptr(),
          "the device pointer of pinned host memory differs from its host address")
    return dptr.value


# cudaDevAttrHostNativeAtomicSupported (driver_types.h)
HOST_NATIVE_ATOMICS = 86


def device_attribute(attr: int, device: int = 0) -> int:
    value = ctypes.c_int()
    err = library().hkv_device_attribute(attr, device, ctypes.byref(value))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute({attr}) failed: cudaError {err}")
    return value.value


# The value planes the kernels take: float32 and bfloat16.
VALUE_DTYPES = (torch.float32, torch.bfloat16)


def check_values(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """A value plane or batch: float32 or bfloat16, contiguous, `shape`."""
    check(t.dtype in VALUE_DTYPES, f"{name}: dtype {t.dtype}, expected float32 or bfloat16")
    check_tensor(name, t, t.dtype, shape, device, t.element_size())


def check_plane(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """A value plane on `device`, or (the 'hmem' tier) a CPU plane in
    pinned, mapped host memory beside tensors on the card, which the
    kernel reads and writes over the host link."""
    if t.device.type == "cpu" and device.type == "cuda":
        device_pointer(t)
        device = t.device
    check_values(name, t, shape, device)


def copy_unit(byte_counts, tensors) -> int:
    """The widest copy unit (16, 4 or 2 bytes) that divides every row
    length in `byte_counts` and every tensor's address: value rows move in
    16-byte words where every row starts on a 16-byte boundary."""
    for unit in (16, 4, 2):
        if all(b % unit == 0 for b in byte_counts) and all(
                t.data_ptr() % unit == 0 for t in tensors):
            return unit
    raise ValueError(f"rows of {list(byte_counts)} bytes have no 2-byte copy unit")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device, align: int = 1) -> None:
    """The wrappers take exactly the layout their kernel reads; `align` is
    the byte alignment of the kernel's widest load from `t`."""
    check(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    check(tuple(t.shape) == tuple(shape), f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    check(t.device == device, f"{name}: on {t.device}, expected {device}")
    check(t.is_contiguous(), f"{name}: not contiguous")
    check(t.data_ptr() % align == 0, f"{name}: not aligned to {align} bytes")
