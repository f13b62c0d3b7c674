"""Build, load and launch the port's CUDA kernels (`csrc/*.cu`).

The sources compile with nvcc for sm_90a, one process per source, and link
into one shared library with a plain C interface, in `eigen_zkvm_tpu_torch/_build/` (git-ignored), at first
use: when a CUDA tensor first reaches a kernel.  A source newer than the
library triggers a rebuild.  The library is loaded with ctypes; every pointer
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


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    newest = max(os.path.getmtime(p)
                 for p in glob.glob(os.path.join(CSRC, "*.cu*")))
    return os.path.getmtime(LIB_PATH) < newest


def build(force: bool = False) -> dict:
    """Compile csrc/*.cu into LIB_PATH when it is missing or stale (or
    `force`): one nvcc per source, all started together, then one link.
    Returns {"seconds", "log"}; `log` holds ptxas's register and
    shared-memory report."""
    if not force and not _stale():
        return {"seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}."
                                      f"{os.getpid()}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    outputs = [p.communicate() for _, _, p in jobs]  # reap all before raising
    log = ""
    for (src, _, p), (out, err) in zip(jobs, outputs):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed on {src} ({p.returncode}):\n{err}")
        log += out + err
    objs = [obj for _, obj, _ in jobs]
    r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                       capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise KernelError(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent build never loads half a file
    return {"seconds": seconds, "log": log + r.stdout + r.stderr}


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
    "fr_ntt_stage": [_I, _VP, _VP, _I, _I, _VP],
    "fr_mul": [_I, _VP, _VP, _I, _VP, _LL, _VP],
    "fr_quotient": [_I, _VP, _VP, _VP, _VP, _VP, _LL, _VP],
    "r1cs_eval": [_I, _VP, _VP, _VP, _VP, _VP, _LL, _VP, _VP],
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
FR_NTT = Kernel("fr_ntt", "fr_ntt_stage",
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
