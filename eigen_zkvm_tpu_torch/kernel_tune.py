"""Launch shapes and design choices of the CUDA kernels, measured side by side.

    python -m eigen_zkvm_tpu_torch.kernel_tune         # needs one GPU + nvcc
    python -m eigen_zkvm_tpu_torch.kernel_tune --r1cs  # K4's row threshold

Each variant is the kernel's source with one constant or line replaced
(registers capped differently, another unroll, more threads), compiled into
its own library under `_build/tune/` and timed with CUDA events at the main
path's shapes beside the source as it stands ("base"), with ptxas's
registers and spills.  Every variant must agree bit for bit with base.  The
constants in csrc/*.cu were chosen from these readings; a variant that
spills is listed for its time only, the kernels ship spill-free.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

# variant name -> [(file, old text, new text), ...]
POSEIDON_VARIANTS = {
    "base": [],
    "min_blocks_1 (registers uncapped)": [
        ("poseidon_gl.cu", "kMinBlocks = 3", "kMinBlocks = 1")],
    "min_blocks_4 (128 registers)": [
        ("poseidon_gl.cu", "kMinBlocks = 3", "kMinBlocks = 4")],
    "partial rounds unrolled 22": [
        ("poseidon_gl.cu", "kPartialUnroll = 11", "kPartialUnroll = 22")],
    "partial rounds rolled": [
        ("poseidon_gl.cu", "kPartialUnroll = 11", "kPartialUnroll = 1")],
    "squares as four limb products": [
        ("gl.cuh", "const U128 p = sqr_wide(a);\n  return reduce128(",
         "const U128 p = mul_wide(a, a);\n  return reduce128(")],
}
NTT_VARIANTS = {
    "base": [],
    "2 blocks an SM up to 2^10 rows (128 registers)": [
        ("ntt.cu", "kMinBlocks = 3", "kMinBlocks = 2")],
    "512 threads for the 2^11-row tile": [
        ("ntt.cu", "kThreadsBig = 896", "kThreadsBig = 512")],
    "1024 threads for the 2^11-row tile (64 registers)": [
        ("ntt.cu", "kThreadsBig = 896", "kThreadsBig = 1024")],
    "tile accesses unrolled 4 in both kernels": [
        ("ntt.cu", "kUnroll = BIG ? 4 : 2", "kUnroll = 4")],
}


def _build_variants(source: str, variants: dict) -> dict:
    """{name: (library path, ptxas lines)}; all compiles run together."""
    from . import kernels

    nvcc = kernels._nvcc()
    root = os.path.join(kernels.BUILD_DIR, "tune")
    jobs = {}
    for i, (name, subs) in enumerate(variants.items()):
        src_dir = os.path.join(root, f"{source}.{i}")
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(kernels.CSRC, src_dir)
        for fname, old, new in subs:
            path = os.path.join(src_dir, fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise kernels.KernelError(f"{name}: {old!r} not in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        lib = os.path.join(src_dir, "variant.so")
        jobs[name] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib,
             os.path.join(src_dir, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise kernels.KernelError(f"nvcc failed on {name}:\n{log}")
        built[name] = (lib, [ln.split("info    :")[-1].strip()
                             for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built


class _Swapped:
    """The loaded library with some entries taken from a variant's."""

    def __init__(self, real, variant, symbols):
        self._real, self._variant, self._symbols = real, variant, symbols

    def __getattr__(self, name):
        return getattr(self._variant if name in self._symbols else self._real,
                       name)


def _run_variants(source: str, variants: dict, symbols, prepare, cases):
    """Time every case under every variant; `prepare(lib)` readies a variant
    library (constants); each case is (label, fn) with fn returning a
    tensor, compared with base's."""
    import torch

    from . import kernels
    from .kernel_probe import _time_ms

    real = kernels.library()
    want = {}
    for name, (path, ptxas) in _build_variants(source, variants).items():
        lib = kernels.bind(ctypes.CDLL(path))
        prepare(lib)
        kernels._lib = _Swapped(real, lib, symbols)
        try:
            times = []
            for label, fn in cases:
                got = fn()
                want.setdefault(label, got.clone())
                if not torch.equal(got, want[label]):
                    raise kernels.KernelError(f"{name}: {label} differs")
                times.append(f"{label} {_time_ms(fn):.3f} ms")
        finally:
            kernels._lib = real
        print(f"{source} [{name}]: " + ", ".join(times) + "; ptxas: "
              + " | ".join(ptxas), flush=True)


def r1cs_threshold_sweep(dev, nnz: int = 1 << 21, reps: int = 20) -> list:
    """K4 (csrc/r1cs.cu) on rows of one length L, each row on a thread and
    on a warp: three matrices of nnz / L rows, random wires, every
    coefficient a product (indices 2..9 of a table of ten, 1 and -1 first).
    Both must agree bit for bit.  [(L, thread ms, warp ms)]."""
    import random

    import torch

    from .curves import bn254
    from .kernel_probe import _time_ms
    from .ops import bigint as bi
    from .ops import r1cs

    prng = random.Random(5)
    n_vars = 1 << 21
    wit = bi.mont_ints(bi.FR, [prng.randrange(bn254.R)
                               for _ in range(n_vars)], dev)
    coefs = bi.mont_ints(bi.FR, [1, bn254.R - 1] + [
        prng.randrange(bn254.R) for _ in range(8)], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = []
    for L in (2, 4, 8, 16, 32, 64):
        nc = nnz // L
        rows = r1cs.Rows(
            nc=nc, indptr=torch.arange(0, 3 * nc * L + 1, L, device=dev,
                                       dtype=torch.int32),
            wires=torch.randint(0, n_vars, (3 * nc * L,), device=dev,
                                dtype=torch.int32, generator=gen),
            cidx=torch.randint(2, 10, (3 * nc * L,), device=dev,
                               dtype=torch.int16, generator=gen),
            coefs=coefs, dest=torch.arange(3 * nc, device=dev,
                                           dtype=torch.int32),
            n_short=3 * nc)
        ms = []
        for n_short in (3 * nc, 0):
            rs = dataclasses.replace(rows, n_short=n_short)
            ms.append((_time_ms(lambda: r1cs.evaluate(rs, wit, nc, 0),
                                reps), r1cs.evaluate(rs, wit, nc, 0)))
        if not torch.equal(ms[0][1], ms[1][1]):
            raise AssertionError(f"r1cs rows of {L}: thread and warp differ")
        out.append((L, ms[0][0], ms[1][0]))
        print(f"r1cs rows of {L} nonzeros, {nc} a matrix: a thread a row "
              f"{ms[0][0]:.4f} ms, a warp a row {ms[1][0]:.4f} ms",
              flush=True)
    return out


def main(argv=None) -> int:
    import numpy as np

    from . import kernels
    from .hash import poseidon as pnp
    from .ops import gl, ntt, poseidon
    from .utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    print(f"card: {card_line()}")
    if "--r1cs" in (sys.argv[1:] if argv is None else argv):
        r1cs_threshold_sweep(dev)
        return 0
    rng = np.random.default_rng(3)

    def rand(*shape):
        return gl.from_u64(rng.integers(0, 2**64, size=shape, dtype=np.uint64)
                           % np.uint64(gl.P_INT), dev)

    def poseidon_constants(lib):
        keep = [np.ascontiguousarray(a, dtype=np.uint64)
                for a in (pnp.C, pnp.M, pnp.PMAT, pnp.S)]
        kernels.check("poseidon_gl_set_constants",
                      lib.poseidon_gl_set_constants(
                          dev.index, *[a.ctypes.data for a in keep]))

    st = rand(1 << 20, 12)
    poseidon.permute(st[:1])  # base's constants are on the device
    _run_variants("poseidon_gl.cu", POSEIDON_VARIANTS, {"poseidon_gl"},
                  poseidon_constants,
                  [("permute B=2^20", lambda: poseidon.permute(st))])
    del st
    x, q = rand(1 << 20, 8), rand(1 << 21, 3)
    leaf_x, grp = rand(1 << 8, 1 << 16), rand(1 << 5, 3 << 16)
    _run_variants("ntt.cu", NTT_VARIANTS, {"ntt_leaf"}, lambda lib: None, [
        ("interpolate [2^20,8]->[2^21,8]", lambda: ntt.interpolate(x, 20, 21)),
        ("leaf [2^8,2^16]", lambda: ntt._leaf(leaf_x, 8, ntt._root(8))),
        ("Q-split intt [2^21,3]", lambda: ntt.intt(q, 21)),
        ("Q-split ntt [2^21,3]", lambda: ntt.ntt(q, 21)),
        ("fold group intt [2^5,3*2^16]", lambda: ntt.intt(grp, 5))])
    return 0


if __name__ == "__main__":
    sys.exit(main())
