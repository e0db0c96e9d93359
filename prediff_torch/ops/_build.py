"""Builds the port's CUDA sources and loads them with ctypes; the plumbing
the kernel wrappers share (argument checks, pointers, the gradients their
``autograd.Function``s take from plain versions).

Each ``prediff_torch/csrc/<name>.cu`` has a plain C interface and compiles
on its own with ``nvcc`` for ``sm_90a`` into ``<repo>/build/lib<name>_<hash>.so``
(the hash is of the source, the ``*.cuh`` headers beside it and the flags, so
an edited source builds anew).  Nothing is
built when a module is imported: the first launch builds what it needs, and
:func:`build_all` builds every source at once, one ``nvcc`` per source, all
started together, each spreading its optimisation passes over the cores
(``--split-compile=0``); it may run in a thread of its own while the caller
goes on, a first launch then waiting for its source's build.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("groupnorm", "ffn", "attention", "resblock", "conv3d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_building_lock = threading.Lock()
_building: Dict[str, threading.Event] = {}   # source -> set when its nvcc ends
_running: set = set()   # the nvcc processes not yet ended


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def stop_builds() -> None:
    """Kill every ``nvcc`` a :func:`build_all` still waits for, with the
    compilers it started (a caller that gives up before its build ends)."""
    import signal

    with _building_lock:
        for proc in _running:
            try:
                os.killpg(proc.pid, signal.SIGKILL)   # each nvcc leads a process group
            except ProcessLookupError:
                pass


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing library in parallel; raise on any failure.  A
    source another thread is building is waited for, not built twice.

    Returns per source: wall seconds of its nvcc (0 if already built or
    built by another call) and the ptxas report (registers, shared memory,
    spills)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, theirs = {}, {}
    with _building_lock:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            if name in _building:
                theirs[name] = _building[name]
                continue
            _building[name] = threading.Event()
            tmp = out.with_name(out.name + f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True, start_new_session=True),
                           tmp, out, time.perf_counter())
            _running.add(procs[name][0])
    report = {name: {"seconds": 0.0, "ptxas": ""} for name in names}

    def drain(name, proc, tmp, out, t0):   # each its own thread: a source ends when its nvcc does
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode == 0:
            os.replace(tmp, out)
        with _building_lock:
            _running.discard(proc)
            _building.pop(name).set()

    threads = [threading.Thread(target=drain, args=(name, *job)) for name, job in procs.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    failed = [f"{name}.cu (nvcc exit {proc.returncode}):\n{report[name]['ptxas']}"
              for name, (proc, *_) in procs.items() if proc.returncode != 0]
    for name, done in theirs.items():
        done.wait()
        if not library_path(name).exists():
            failed.append(f"{name}.cu: its build in another thread failed")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
TARGET_BLOCKS = 264     # two blocks for each of the H100's 132 SMs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each exported function to its ctypes argument types
    (``P`` pointer or stream, ``I`` int, ``U`` uint32, ``F`` float); each returns a CUDA
    error code as int."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def require(kernel: str, specs) -> None:
    """Raise unless each (name, tensor, shape[, dtype]) is a contiguous CUDA
    tensor of that shape and dtype (float32 unless given): what the kernels
    take."""
    for name, t, shape, *dtype in specs:
        dtype = dtype[0] if dtype else torch.float32
        if (t.dtype != dtype or not t.is_cuda or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{kernel} kernel: {name} must be a contiguous {dtype} CUDA tensor "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")


def widened(plain):
    """A plain version that also takes bf16 (or f16) tensors, as the JAX
    package's XLA path does: its floating tensor arguments widened to f32
    (exact), the function computed as in f32, and its result (the first of a
    tuple: the output, or dx) in the dtype of its first argument; the
    parameter gradients stay f32 (autograd casts them to their leaves')."""
    def narrow(t):
        return t.float() if isinstance(t, torch.Tensor) and t.is_floating_point() else t

    @functools.wraps(plain)
    def run(*args, **kwargs):
        dtype = args[0].dtype
        out = plain(*(narrow(a) for a in args), **{k: narrow(v) for k, v in kwargs.items()})
        if isinstance(out, tuple):
            return (out[0].to(dtype),) + out[1:]
        return out.to(dtype)

    return run


def io_form(kernel: str, x: torch.Tensor) -> str:
    """The suffix of the entry point for activations of ``x``'s dtype: ""
    for the f32 form, "_bf16" for the bf16 form (the same kernel reading and
    writing bf16, its arithmetic f32); any other dtype raises."""
    if x.dtype == torch.float32:
        return ""
    if x.dtype == torch.bfloat16:
        return "_bf16"
    raise ValueError(f"{kernel} kernel: takes float32 or bfloat16 activations, got {x.dtype}")


# the open scopes of ``utils.profiling.count_kernel_launches``: each a dict
# {"calls": {name: n}, "card": {name: n}, "launched": {name: n}} by wrapper name
SCOPES: list = []


def on_card(wrapper, t: torch.Tensor) -> bool:
    """The dispatch point of ``wrapper``: whether it launches its kernel
    (``t`` a CUDA tensor) rather than its plain version (a CPU tensor).  Each
    open scope counts the call, and whether it went to the card."""
    for scope in SCOPES:
        name = wrapper.__name__
        scope["calls"][name] = scope["calls"].get(name, 0) + 1
        if t.is_cuda:
            scope["card"][name] = scope["card"].get(name, 0) + 1
    return t.is_cuda


def count(wrapper, form: str, activation: str = "gelu") -> None:
    """One launch of ``wrapper``'s kernel: ``.launches`` counts every form,
    ``.bf16_launches`` the bf16 form's, ``.<activation>_launches`` the FFN
    kernels' launches on an activation other than GELU."""
    for scope in SCOPES:
        scope["launched"][wrapper.__name__] = scope["launched"].get(wrapper.__name__, 0) + 1
    wrapper.launches += 1
    if form:
        wrapper.bf16_launches += 1
    if activation != "gelu":
        name = f"{activation}_launches"
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def plain_grads(fn, inputs, needs, g):
    """Gradients of ``fn(*inputs)`` for the cotangent ``g`` by autograd of a
    plain version, for the inputs flagged in ``needs`` (None elsewhere, and
    nothing runs when none is flagged).  The resblock's ``autograd.Function``
    takes its parameter gradients from here and the grouped attention core
    all its gradients, as the JAX package recomputes them from its jnp
    references; the FFN, attention layer and GroupNorm Functions have
    all-gradients kernels instead."""
    if not any(needs):
        return [None] * len(inputs)
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, g))
    return [next(grads) if n else None for n in needs]


# a dropout kernel's trailing arguments: the device seed's address (null for a host seed), the
# seed words, site, (thr, 1 - rate) for its two masks, then their two element bases
DROP_ARGTYPES = [P, U, U, U, U, F, U, F, ctypes.c_uint64, ctypes.c_uint64]


def drop_args(seed, site: int, rate_a: float, rate_b: float, bases=(0, 0),
              device: Optional[torch.device] = None) -> list:
    """The dropout arguments of a kernel (``DROP_ARGTYPES``): for a host seed
    a null address and its two words, for a device seed (``ops/dropout.py``,
    on ``device``) its address and two zero words, which the kernels replace
    by the words they read there; the site, for each rate in [0, 1) its
    threshold and ``1 - rate``, and each mask's element base
    (``csrc/philox.cuh``), a multiple of 4 (any other raises ``ValueError``:
    the layers route such a call to their library ops,
    ``dropout.kernel_bases``)."""
    from .dropout import as_seed, check_rates, kernel_bases, seed_words, threshold

    check_rates(rate_a, rate_b)
    if len(bases) != 2 or not kernel_bases(bases) or min(bases) < 0:
        raise ValueError(f"dropout kernels take two element bases that are multiples of 4, "
                         f"got {tuple(bases)}")
    seed = as_seed(seed)
    if isinstance(seed, torch.Tensor):
        if device is not None and seed.device != device:
            raise ValueError(f"dropout kernels: the device seed lies on {seed.device}, the "
                             f"tensors on {device}")
        args = [seed.data_ptr(), 0, 0, int(site)]
    else:
        args = [None, *seed_words(seed), int(site)]
    for rate in (rate_a, rate_b):
        args += [threshold(rate), 1.0 - rate]
    return args + [int(b) for b in bases]


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` (a tensor's, so it has an index)
    as a ``P`` argument, from PyTorch's raw accessor (the one its generated
    code launches on): ``torch.cuda.current_stream(device).cuda_stream``
    gives the same handle but builds a ``Stream`` object per call, host time
    on every launch of a host-bound path."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def aligned16(*tensors) -> list:
    """Each tensor, or a fresh copy where its address is not a multiple of
    16 bytes (the TMA and vector loads of the wgmma kernels need that)."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]


def ptr(t) -> int:
    """A tensor's address for a ``P`` argument (ctypes converts the int)."""
    return t.data_ptr()


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: a wrapper that
    would not goes straight to its kernel, without the cost of an
    ``autograd.Function``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
