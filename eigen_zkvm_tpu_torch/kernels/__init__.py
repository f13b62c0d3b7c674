"""Build, load and launch the port's CUDA kernels (`csrc/*.cu`).

The sources compile with nvcc for sm_90a, one object a source, and link
into one shared library with a plain C interface, in
`eigen_zkvm_tpu_torch/_build/` (git-ignored), at first use: when a CUDA
tensor first reaches a kernel.  Each object keeps the stamp of what it was
built from (the source and the csrc headers it includes); a later build
recompiles only the sources whose stamp changed, all at once, and relinks.
The library is loaded with ctypes; every pointer
and the stream go in as `c_void_p`, every C entry returns
`cudaGetLastError()` after its launch, and a launch that does not return 0
raises `KernelError` (a refused launch never runs, and a later synchronize
would not report it).

Each kernel is a `Kernel` object with a plain-int `launches` count that
`Kernel.launch` bumps once per successful launch, so a run can show which
kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libeigen_zkvm_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class KernelError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # PyTorch's toolkit search

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only where "
                      "the CUDA toolkit is installed")


def _local_includes(path: str) -> list[str]:
    """The csrc headers a source names in `#include "..."` lines."""
    with open(path) as f:
        return [line.split('"')[1] for line in f
                if line.lstrip().startswith("#include") and '"' in line]


def source_stamp(src: str, csrc: str = CSRC) -> str:
    """sha256 of the nvcc flags, the source and every csrc header it
    includes, directly or through another: what its object depends on."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        todo += [os.path.join(csrc, name) for name in _local_includes(path)]
    for path in sorted(seen):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return None


def _write(path: str, text: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build(force: bool = False, csrc: str = CSRC, build_dir: str = BUILD_DIR,
          nvcc: str | None = None) -> dict:
    """Compile what is stale of csrc/*.cu, one object a source kept in
    `build_dir`, and link them all into the library there.  A source is
    stale when its object is missing or was built from other contents of
    it or of a header it includes (`source_stamp`, kept beside the object),
    so an edit of one .cu recompiles that one and an edit of a .cuh the
    sources that include it; `force` recompiles all.  The nvcc jobs run
    together, then one link.  Returns {"seconds", "compiled" (the sources'
    names), "log"}; `log` holds ptxas's register and shared-memory report
    of the compiled ones."""
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    stamps = {src: source_stamp(src, csrc) for src in srcs}

    def obj(src):
        return os.path.join(build_dir, os.path.basename(src) + ".o")

    todo = [src for src in srcs
            if force or not os.path.exists(obj(src))
            or _read(obj(src) + ".stamp") != stamps[src]]
    lib = os.path.join(build_dir, os.path.basename(LIB_PATH))
    lib_stamp = hashlib.sha256(" ".join(
        stamps[src] for src in srcs).encode()).hexdigest()
    if not todo and os.path.exists(lib) and \
            _read(lib + ".stamp") == lib_stamp:
        return {"seconds": 0.0, "compiled": [], "log": ""}
    os.makedirs(build_dir, exist_ok=True)
    nvcc = nvcc or _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        tmp = f"{obj(src)}.{os.getpid()}.tmp"
        jobs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    outputs = [p.communicate() for _, _, p in jobs]  # reap all before raising
    log = ""
    for (src, tmp, p), (out, err) in zip(jobs, outputs):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed on {src} ({p.returncode}):\n{err}")
        log += out + err
    for src, tmp, _ in jobs:  # the object first: a stale stamp rebuilds
        os.replace(tmp, obj(src))
        _write(obj(src) + ".stamp", stamps[src])
    tmp = f"{lib}.{os.getpid()}.tmp"
    r = subprocess.run([nvcc, "-shared", "-o", tmp, *map(obj, srcs)],
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise KernelError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    _write(lib + ".stamp", lib_stamp)
    return {"seconds": seconds,
            "compiled": [os.path.basename(src) for src in todo],
            "log": log + r.stdout + r.stderr}


# every C entry of the library: its argument types (all return int)
SIGNATURES = {
    "ntt_leaf": [_I, _VP, _VP, _VP, _VP, _I, _I, _LL, _LL, _I, _I, _VP],
    "poseidon_gl_set_constants": [_I, _VP, _VP, _VP, _VP],
    "poseidon_gl": [_I, _VP, _LL, _I, _VP, _VP, _LL, _I, _LL, _VP],
    "imad_probe": [_I, _I, _I, _I, _VP, _VP, _VP],
    "imad_probe_chains": [],
    "gl_check": [_I, _I, _VP, _VP, _VP, _LL, _I, _VP],
    "bn254_check": [_I, _I, _I, _VP, _VP, _VP, _LL, _VP],
    "msm_digits": [_I, _VP, _I, _VP, _LL, _I, _I, _VP, _VP, _VP, _VP],
    "msm_level": [_I, _I, _I, _VP, _VP, _VP, _LL, _I, _VP, _VP, _VP, _VP],
    "msm_level_capacity": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "msm_window_chunks": [_I, _I, _VP, _I, _I, _I, _VP, _VP],
    "msm_combine": [_I, _I, _VP, _I, _I, _VP, _VP],
    "ec_fixed_base": [_I, _I, _VP, _VP, _LL, _VP, _VP, _VP],
    "fr_ntt_pass": [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "fr_mul": [_I, _VP, _VP, _I, _VP, _LL, _VP],
    "fr_quotient": [_I, _VP, _VP, _VP, _VP, _VP, _LL, _VP],
    "r1cs_eval": [_I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _LL, _LL, _LL, _LL,
                  _VP, _VP],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the entries `lib` has (a
    library built from some of the sources has some of them)."""
    for symbol, argtypes in SIGNATURES.items():
        if hasattr(lib, symbol):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, _I
    if hasattr(lib, "cuda_error_string"):
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = bind(ctypes.CDLL(LIB_PATH))
        return _lib


def check(name: str, err: int):
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise KernelError(f"{name}: CUDA error {err}: {msg}")


class Kernel:
    """One hand-written CUDA kernel: its C entry (or entries, one a stage)
    and its launch count."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, device_index: int, *args, stream: int,
               entry: str | None = None):
        """Call the C entry (`entry`, else the kernel's own) on
        `device_index` and PyTorch's `stream`."""
        err = getattr(library(), entry or self.symbol)(device_index, *args,
                                                        stream)
        check(self.name, err)
        self.launches += 1


NTT = Kernel("ntt", "ntt_leaf", "eigen_zkvm_tpu_torch/csrc/ntt.cu",
             "eigen_zkvm_tpu/ops/ntt_pallas.py:158")
POSEIDON = Kernel("poseidon_gl", "poseidon_gl",
                  "eigen_zkvm_tpu_torch/csrc/poseidon_gl.cu",
                  "eigen_zkvm_tpu/ops/poseidon_pallas.py:51, "
                  "eigen_zkvm_tpu/ops/poseidon_mxu.py:249")
MSM = Kernel("msm", "msm_level", "eigen_zkvm_tpu_torch/csrc/msm.cu",
             "eigen_zkvm_tpu/ops/ec_jax.py::_msm_core (:154, with "
             "_tree_reduce :127)")
EC_BATCH = Kernel("ec_batch", "ec_fixed_base",
                  "eigen_zkvm_tpu_torch/csrc/ec_batch.cu",
                  "eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all (:221)")
FR_NTT = Kernel("fr_ntt", "fr_ntt_pass",
                "eigen_zkvm_tpu_torch/csrc/fr_ntt.cu",
                "eigen_zkvm_tpu/groth16/groth16.py::_witness_h (:315; "
                "_ntt/_intt :34-72)")
R1CS = Kernel("r1cs", "r1cs_eval", "eigen_zkvm_tpu_torch/csrc/r1cs.cu",
              "eigen_zkvm_tpu/groth16/groth16.py::_witness_h (:315; "
              "_r1cs_csr :283)")
KERNELS = (NTT, POSEIDON, MSM, EC_BATCH, FR_NTT, R1CS)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def pointer(t) -> int | None:
    """A tensor's device address for a c_void_p argument (None -> NULL)."""
    return None if t is None else t.data_ptr()
