"""Build, load and launch the port's CUDA kernels (`csrc/*.cu`).

The sources compile with nvcc for sm_90a, one object a source, and link
into one shared library with a plain C interface, in
`eigen_zkvm_tpu_torch/_build/` (git-ignored), at first use: when a CUDA
tensor first reaches a kernel.  Each object keeps the stamp of what it was
built from (the source and the csrc headers it includes); a later build
recompiles only the sources whose stamp changed, all at once, and relinks.
`load(sources)` builds and loads the sources named alone, for a tool that
times a few kernels.  The library is loaded with ctypes; every pointer
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
import re
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
          nvcc: str | None = None, sources=None) -> dict:
    """Compile what is stale of csrc/*.cu (or of the `sources` named, file
    names in csrc), one object a source kept in `build_dir`, and link them
    all into the library there.  A source is
    stale when its object is missing or was built from other contents of
    it or of a header it includes (`source_stamp`, kept beside the object),
    so an edit of one .cu recompiles that one and an edit of a .cuh the
    sources that include it; `force` recompiles all.  The nvcc jobs run
    together, then one link.  Returns {"seconds", "compiled" (the sources'
    names), "log"}; `log` holds ptxas's register and shared-memory report
    of the compiled ones, and `jobs` one record a compiled source: its
    name, the seconds from the start of the build to the end of its nvcc
    job (the jobs run together, so the build's wall is the slowest job's
    plus the link) and its `ptxas` report (`ptxas_report`)."""
    srcs = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    if sources is not None:
        missing = set(sources) - {os.path.basename(src) for src in srcs}
        if missing:
            raise KernelError(f"no {sorted(missing)} in {csrc}")
        srcs = [src for src in srcs if os.path.basename(src) in sources]
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
        return {"seconds": 0.0, "compiled": [], "log": "", "jobs": []}
    os.makedirs(build_dir, exist_ok=True)
    nvcc = nvcc or _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        tmp = f"{obj(src)}.{os.getpid()}.tmp"
        jobs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    outputs, ends = [None] * len(jobs), [0.0] * len(jobs)

    def reap(i):  # each job's output and the time it ended
        outputs[i] = jobs[i][2].communicate()
        ends[i] = time.perf_counter() - t0

    reapers = [threading.Thread(target=reap, args=(i,))
               for i in range(len(jobs))]
    for t in reapers:
        t.start()
    for t in reapers:  # reap all before raising
        t.join()
    log, records = "", []
    for (src, tmp, p), (out, err), end in zip(jobs, outputs, ends):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed on {src} ({p.returncode}):\n{err}")
        log += out + err
        records.append({"source": os.path.basename(src), "seconds": end,
                        "ptxas": ptxas_report(out + err)})
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
            "log": log + r.stdout + r.stderr,
            "jobs": sorted(records, key=lambda j: -j["seconds"])}


def ptxas_report(log: str) -> list[str]:
    """ptxas's `-v` lines of a compile: each register line and spill line
    under the kernel it follows (`Compiling entry function`), the kernel's
    mangled name cut after its anonymous namespace's source tag."""
    out, entry = [], ""
    for line in log.splitlines():
        text = line.split("info    :")[-1].strip()
        if "Compiling entry function" in text:
            entry = text.split("'")[1] if "'" in text else text
            tag = re.search(r"_cu_[0-9a-f]{8}\d+", entry)
            entry = entry[tag.end():] if tag else entry
        elif "registers" in text or "spill" in text:
            out.append(f"{entry}: {text}")
    return out


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
    **{f"{pre}_{name}": argtypes
       for pre in ("msm", "msm_g2", "msm_bls", "msm_bls_g2")
       for name, argtypes in (
           ("level", [_I, _I, _I, _VP, _VP, _VP, _LL, _I, _VP, _VP, _VP,
                      _VP]),
           ("level_capacity", [_I, _I, ctypes.POINTER(ctypes.c_int)]),
           ("window_chunks", [_I, _I, _VP, _I, _I, _I, _VP, _VP]),
           ("combine", [_I, _I, _VP, _I, _I, _VP, _VP]))},
    "ec_fixed_base": [_I, _I, _VP, _VP, _LL, _VP, _VP, _VP],
    "ec_bls_fixed_base": [_I, _I, _VP, _VP, _LL, _VP, _VP, _VP],
    "fr_ntt_pass": [_I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP],
    "fr_mul": [_I, _I, _VP, _VP, _I, _VP, _LL, _VP],
    "fr_quotient": [_I, _I, _VP, _VP, _VP, _VP, _VP, _LL, _VP],
    "r1cs_eval": [_I, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _LL, _LL, _LL,
                  _LL, _VP, _VP],
    "poseidon_fr": [_I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                    _VP, _I, _LL, _VP],
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


def load(sources=None) -> dict:
    """Build and load the library every later launch goes through: of the
    `sources` named (file names in csrc) alone, in a directory of their own
    under BUILD_DIR (a tool that times some kernels builds in seconds what
    the whole library takes minutes for), or of all of them.  With no
    `sources`, a library already loaded stays.  Returns build()'s report,
    with the library's path under "lib"."""
    global _lib
    with _lock:
        if sources is None and _lib is not None:
            return {"seconds": 0.0, "compiled": [], "log": "", "lib": None}
        build_dir = BUILD_DIR if sources is None else os.path.join(
            BUILD_DIR, "+".join(sorted(sources)))
        info = build(build_dir=build_dir, sources=sources)
        info["lib"] = os.path.join(build_dir, os.path.basename(LIB_PATH))
        _lib = bind(ctypes.CDLL(info["lib"]))
        return info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built and loaded first if needed."""
    if _lib is None:
        load()
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
# The Groth16 kernels at BLS12-381: K1 and K2 are their own translation
# units (msm_bls.cu, ec_batch_bls.cu; msm_digits is every curve's), K3 and
# K4 the BN254 sources' second field; each counts its own launches.  The JAX package runs this curve's
# Groth16 on the host (native/ec_curves.cpp through groth16.py::_native_ec
# :208), with no pallas_call.
MSM_BLS = Kernel("msm_bls12381", "msm_bls_level",
                 "eigen_zkvm_tpu_torch/csrc/msm_bls.cu",
                 "eigen_zkvm_tpu/groth16/groth16.py::_msm (:241; "
                 "native/ec_curves.cpp:2045, the BLS12-381 Pippenger), host "
                 "code with no pallas_call")
EC_BATCH_BLS = Kernel("ec_batch_bls12381", "ec_bls_fixed_base",
                      "eigen_zkvm_tpu_torch/csrc/ec_batch_bls.cu",
                      "eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all "
                      "(:221) at BLS12-381, host code with no pallas_call")
FR_NTT_BLS = Kernel("fr_ntt_bls12381", "fr_ntt_pass",
                    "eigen_zkvm_tpu_torch/csrc/fr_ntt.cu",
                    "eigen_zkvm_tpu/groth16/groth16.py::_witness_h (:315; "
                    "_ntt/_intt :34-72) at BLS12-381's r, host code with no "
                    "pallas_call")
R1CS_BLS = Kernel("r1cs_bls12381", "r1cs_eval",
                  "eigen_zkvm_tpu_torch/csrc/r1cs.cu",
                  "eigen_zkvm_tpu/groth16/groth16.py::_witness_h (:315; "
                  "_r1cs_csr :283) at BLS12-381's r, host code with no "
                  "pallas_call")
POSEIDON_FR = Kernel("poseidon_fr", "poseidon_fr",
                     "eigen_zkvm_tpu_torch/csrc/poseidon_fr.cu",
                     "eigen_zkvm_tpu/native/poseidon_fr.cpp:432 "
                     "(posfr_hash_batch; hash/poseidon_big.py:132 hash_ex), "
                     "host code with no pallas_call")
KERNELS = (NTT, POSEIDON, MSM, EC_BATCH, FR_NTT, R1CS, POSEIDON_FR, MSM_BLS,
           EC_BATCH_BLS, FR_NTT_BLS, R1CS_BLS)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def pointer(t) -> int | None:
    """A tensor's device address for a c_void_p argument (None -> NULL)."""
    return None if t is None else t.data_ptr()
