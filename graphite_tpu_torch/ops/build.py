"""Build the CUDA kernels from `csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The build happens at first use, into `graphite_tpu_torch/_build/` (listed
in `.gitignore`); every source is compiled by its own `nvcc` process, all
started together, with `-Xptxas=-v` so that `BUILD_LOGS` keeps each
kernel's registers, shared memory and spills.  The library name carries a
hash of the sources, so an edited kernel is never served from a stale
build.  Nothing here runs at import time, and nothing here runs on the
CPU path: the wrappers in `ops/` reach a launch only for CUDA tensors.

Each `Kernel` keeps an integer `launches` count, which `launch_bound`
increments once per call of its C entry point and nowhere else.  Every
entry point launches exactly one kernel, so the count is the number of
kernel launches.  `packs` counts the argument sets it validated.

The launch path (`Kernel.launch_bound`), the only one.  Validating and
packing every argument on every call costs tens of microseconds of
Python, several times a kernel's device time.  Every entry point takes
`(const Args*, stream)`: one argument block, a struct of the tensors'
pointers and the kernel's plain values.  A kernel validates a set of
tensors once (device, dtype, shape, contiguity) and packs the block
(its `pack`); while later calls pass the very same tensor objects and
the same plain values, a launch is one ctypes call with that block.
The binding holds a weak reference to each tensor and checks on every
call that each one still resolves to the tensor passed (`ref() is
t`): a tensor that was freed resolves to None, so its pointer is never
used again, and an object id reused for another tensor never matches.
The binding keeps nothing alive, so a replaced state
(`Simulator.warmup`'s clone, a new `qend`) is freed as usual, and the
next call validates and binds anew.  (A tensor freed while its
kernel still runs is safe as for any PyTorch op: the launch is on
PyTorch's current stream, whose order the caching allocator keeps.)
Each kernel keeps only its newest binding.  The port never re-points a
bound tensor in place (`set_`, `resize_`), which an identity check
could not see.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import operator
import os
import subprocess
import threading
import time
import weakref

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNEL_NAMES = ("lane_fetch_cost", "user_mailbox", "barrier_sync",
                "lane_commit", "mem_requester", "mem_home_start",
                "mem_requester_fill", "iocoom_commit", "noc_route",
                "atac_route", "mem_net_route", "shl2_requester",
                "shl2_home_start", "shl2_requester_fill")

_lock = threading.Lock()
_libs: dict = {}
# kernel name -> nvcc's output of its last build in this process
BUILD_LOGS: dict = {}


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for fn in (f"{name}.cu", "common.cuh", "mem_common.cuh",
               "queue_common.cuh", "net_route.cuh", "shl2_common.cuh",
               "fanout.cuh"):
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_source_hash(name)}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc) to build the "
                           "graphite_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all(names=KERNEL_NAMES) -> float:
    """Compile every missing kernel library, one `nvcc` per source, all in
    parallel.  Returns the wall seconds spent (0.0 when all were built)."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        BUILD_LOGS[n] = log
        if p.returncode != 0:
            errors.append(f"{n}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(_lib_path(name))
            lib.gt_error_string.argtypes = [ctypes.c_int]
            lib.gt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


P = ctypes.c_void_p
_NONES = itertools.repeat(None)


class Binding:
    """One validated argument set of a kernel: weak references to its
    tensors (see the module doc), the plain values `key`, and the packed
    argument block whose address the C entry point reads."""

    __slots__ = ("refs", "present", "key", "block", "address", "device")

    def __init__(self, tensors: tuple, key: tuple, block):
        # an optional argument left out (None) holds no reference
        self.present = tuple(t is not None for t in tensors)
        self.refs = tuple(weakref.ref(t) for t in tensors if t is not None)
        self.key, self.block = key, block
        self.address = ctypes.addressof(block)
        self.device = tensors[0].device

    def holds(self, tensors: tuple, key: tuple) -> bool:
        """Whether these very (live) tensor objects and values are the
        ones bound, with the same arguments left out."""
        return (self.key == key
                and tuple(map(operator.is_not, tensors, _NONES))
                == self.present
                and all(map(operator.is_, map(operator.call, self.refs),
                            itertools.compress(tensors, self.present))))


class Kernel:
    """One CUDA entry point `symbol(args block, stream)`.  Its wrapper
    calls `launch_bound(tensors, key)`, which launches on PyTorch's
    current stream, raises on a non-zero launch status and counts the
    launch; `pack(tensors, key)` validates the arguments and returns the
    block (a ctypes array).  `lib` names the kernel library (`csrc/<lib>.cu`)
    when it differs from `name`: a second entry point of one library, such
    as a template instantiation counted apart."""

    def __init__(self, name: str, symbol: str, pack, lib: str = ""):
        self.name = name
        self.symbol = symbol
        self.pack = pack
        self.lib = lib or name
        self.source = f"graphite_tpu_torch/csrc/{self.lib}.cu"
        self.launches = 0
        self.packs = 0
        self.binding = None
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [P, P]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def _raise(self, rc: int) -> None:
        msg = self._lib.gt_error_string(rc).decode()
        raise RuntimeError(f"{self.name}: launch failed: {msg} ({rc})")

    def bind(self, tensors: tuple, key: tuple) -> Binding:
        """The binding of `tensors` and `key`: the kernel's current one
        when it holds these very objects and values, else a new one that
        replaces it (validated by `pack`, which raises on a bad
        argument).  Launches nothing."""
        b = self.binding
        if b is not None and b.holds(tensors, key):
            return b
        self.binding = None          # never hold two argument sets
        b = Binding(tensors, key, self.pack(tensors, key))
        self.packs += 1
        self.binding = b
        return b

    def launch_bound(self, tensors: tuple, key: tuple) -> None:
        b = self.bind(tensors, key)
        if b.device.type != "cuda":
            raise ValueError(f"{self.name}: tensors on {b.device}")
        fn = self._fn or self._bind()
        # the current stream's raw handle, without building the Stream
        # object torch.cuda.current_stream() returns (several us a call)
        stream = torch._C._cuda_getCurrentRawStream(b.device.index)
        rc = fn(b.address, stream)
        if rc != 0:
            self._raise(rc)
        self.launches += 1


def check_width(name: str, n: int, limit: int, what: str) -> None:
    """A one-CTA kernel's refusal of a width past its block (its
    wrapper's, and `Simulator`'s at construction on a card)."""
    if n > limit:
        raise ValueError(f"{name}: {n} {what}, at most {limit}")


def check(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    """Validate one kernel argument; returns its data pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def pack_args(tensors: tuple, specs, values=()) -> ctypes.Array:
    """Validate `tensors` against `specs` ((name, dtype, shape) each, all
    on the first tensor's device) and pack their pointers, then the
    integers `values`, into one block of int64 words.  A None tensor (an
    optional argument left out) packs a null pointer."""
    if len(tensors) != len(specs):
        raise ValueError(f"{len(tensors)} tensors for {len(specs)} "
                         "arguments")
    dev = tensors[0].device if isinstance(tensors[0], torch.Tensor) else None
    words = [0 if t is None else check(t, *spec, dev)
             for t, spec in zip(tensors, specs)]
    words += [int(v) for v in values]
    return (ctypes.c_int64 * len(words))(*words)
