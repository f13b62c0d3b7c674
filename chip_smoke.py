#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eigen_zkvm_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each of which fails the run (non-zero exit, no result line):
  1. probe    a CUDA device must be present; prints the card's name and
              power limit as nvidia-smi reports them.
  2. build    compiles eigen_zkvm_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels  the device field primitives (csrc/gl.cuh) against Python
              integers on every ordered pair of their edge operands and 2^20
              random pairs; then each kernel against its plain PyTorch
              version on the card at the main path's shapes, bit for bit
              (tolerance 0: finite-field integer arithmetic), edge states and
              all-zero / all-(p-1) columns mixed into the random inputs, with
              both times from CUDA events.  The measured IMAD.WIDE.U32 issue
              rate is printed beside the one the bounds assume.
  4. prove    the chain AIR of scripts/bench_big.py at 2^20 rows x 8 columns
              (blowup 2, 8 queries), written to files and proved through the
              port's file-based stark_prove on the card, device-resident
              (commits, constraint VM, Q split, openings, FRI folds), which
              verifies its proof: stage split, peak device memory, kernel
              launch counts.  The proof JSON's sha256 must equal
              HOST_PROOF_SHA256, the digest of eigen_zkvm_tpu's host-engine
              proof of the same files.  No module of JAX or of the JAX
              package (eigen_zkvm_tpu) may have been loaded.

Phase 3 holds each kernel at every shape the main path gives it: the NTT
at the LDE of a section, a leaf tile, the Q split's iNTT and NTT and the
FRI fold's group iNTT; Poseidon at a Merkle level, a bare permutation and
a fold tree's 96-wide leaves (the sponge calls that chain a capacity).

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and the IMADs its function needs at the least
over the card's peak IMAD rate (constants below).  The IMADs are counted
from the function, not from the kernel: its field products (butterflies
and scales of a radix-2 transform, the S-boxes and linear layers of the
Poseidon opt schedule), each priced at the fewest 32-bit multiply-adds the
ISA allows for it.  No single PyTorch call computes a Goldilocks NTT or a
Poseidon permutation, so `library_ms` is null.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

NBITS, WIDTH, QUERIES = 20, 8, 8
# sha256 of the proof JSON that eigen_zkvm_tpu's host engine writes for this
# chain AIR (its file-based stark_prove, from the files that
# bench_chain.write_chain_files writes).  The CUDA test
# tests/test_torch_prove.py::test_port_on_the_card_matches_host_engine_at_smoke_size
# proves both engines at this size and holds both to this digest.
HOST_PROOF_SHA256 = \
    "7d6bf093c6afc7d4f4467d3fbc27701343f67b291fab11508b7519964610390b"
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# Fewest IMADs (IMAD.WIDE.U32, a 32x32->64-bit multiply-add) for one
# Goldilocks product: a 64x64-bit product is four limb products, a square
# three (the cross product once, doubled by a shift), a product by a
# constant below 2^32 two.  Reducing mod p = 2^64 - 2^32 + 1 takes shifts
# and adds only.
IMAD_MUL, IMAD_SQR, IMAD_SMALL = 4, 3, 2
# Peak IMAD issue: 64 per clock on each of the 132 SMs (half the float32
# FMA lanes), at the 1.98 GHz at which the data sheet's 67 TFLOP/s float32
# holds.
IMAD_PER_S = 132 * 64 * 1.98e9
# One Poseidon-GL permutation in the opt schedule (hash/poseidon.py): 118
# x^7 S-boxes (12 lanes in each of 8 full rounds, one in each of 22 partial
# rounds; two squares and two products each), 7 MDS layers of 144 products
# by entries below 2^6, the dense pre-partial matrix (144 products) and 22
# sparse partial-round layers (12 + 11 products each).
POSEIDON_IMADS = (118 * (2 * IMAD_SQR + 2 * IMAD_MUL) + 7 * 144 * IMAD_SMALL
                  + (144 + 22 * 23) * IMAD_MUL)


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up (tables, first launch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ntt_imads(log_n: int, cols: int, scaled: bool) -> int:
    """IMADs of a radix-2 transform of 2^log_n rows x cols: n/2 log n
    butterfly products a column, and one more a value when the output is
    scaled (n^-1, the coset)."""
    n = 1 << log_n
    return cols * (n // 2 * log_n + (n if scaled else 0)) * IMAD_MUL


def _bound(nbytes: float, imads: float) -> dict:
    """The least time for the work: bytes over the memory rate, or IMADs
    over the IMAD rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def _max_abs_err(got, want) -> float:
    import torch

    if torch.equal(got, want):
        return 0.0
    diff = got.double() - want.double()  # only reached on a mismatch
    return float(diff.abs().max())


def _hold(label: str, kernel, plain, reps: int, plain_reps: int,
          nbytes: float, imads: float) -> dict:
    """One shape of a kernel: its result against the plain version's on
    the same inputs, both times, its bound."""
    err = _max_abs_err(kernel(), plain())
    ms = _time_ms(kernel, reps)
    plain_ms = _time_ms(plain, plain_reps)
    b = _bound(nbytes, imads)
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
          f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), "
          f"max_abs_err {err}")
    return dict(label=label, err=err, ms=ms, plain_ms=plain_ms, **b)


LEAF_BITS = 8   # the leaf tile held in phase 3: [2^8, 2^16]


def _edge_states(np):
    """Poseidon states at the field's edges: all zero, all p-1, alternating,
    all 2^32-1 (the edge states of tests/test_torch_poseidon.py)."""
    from eigen_zkvm_tpu_torch.ops import gl

    st = np.zeros((4, 12), dtype=np.uint64)
    st[1, :] = gl.P_INT - 1
    st[2, ::2] = gl.P_INT - 1
    st[3, :] = 0xFFFFFFFF
    return st


def _check_kernels(dev, rng) -> list[dict]:
    """Phase 3: each kernel against its plain version at the main path's
    shapes.  The first case of a kernel is the one its line reports; its
    error is the largest over all its cases."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.ops import gl, ntt, poseidon
    import numpy as np

    edge = _edge_states(np)

    def rand(*shape, edge_rows=None):
        """Random field elements; a 2-D shape gets an all-zero first and an
        all-(p-1) second column (NTT inputs), or, with `edge_rows`, those
        rows first (Poseidon inputs)."""
        a = rng.integers(0, 2**64, size=shape, dtype=np.uint64) \
            % np.uint64(gl.P_INT)
        if edge_rows is not None:
            a[: edge_rows.shape[0]] = edge_rows
        elif len(shape) == 2 and shape[1] >= 2:
            a[:, 0] = 0
            a[:, 1] = gl.P_INT - 1
        return gl.from_u64(a, dev)

    n, ext = 1 << NBITS, NBITS + 1
    # NTT: the LDE of a committed section, a leaf tile, the Q split's iNTT
    # and NTT over the extended domain (q_dim 3, q_deg 1), the first FRI
    # fold's group iNTT (2^5 rows, every group and coordinate as a column)
    x = rand(n, WIDTH)
    leaf_x = rand(1 << LEAF_BITS, 1 << 16)
    root = ntt._root(LEAF_BITS)
    q = rand(2 * n, 3)
    grp = rand(1 << 5, 3 << 16)
    ntt_cases = [
        _hold(f"ntt interpolate [2^{NBITS},{WIDTH}]->[2^{ext},{WIDTH}]",
              lambda: ntt.interpolate(x, NBITS, ext),
              lambda: ntt.interpolate_plain(x, NBITS, ext), 20, 3,
              8 * WIDTH * 3 * n,
              _ntt_imads(NBITS, WIDTH, True) + _ntt_imads(ext, WIDTH, False)),
        _hold(f"ntt leaf [2^{LEAF_BITS},2^16]",
              lambda: ntt._leaf(leaf_x, LEAF_BITS, root),
              lambda: ntt.leaf_plain(leaf_x, LEAF_BITS, root), 20, 3,
              8 * 2 * leaf_x.numel(), _ntt_imads(LEAF_BITS, 1 << 16, False)),
        _hold(f"ntt Q-split intt [2^{ext},3]", lambda: ntt.intt(q, ext),
              lambda: ntt.intt_plain(q, ext), 20, 2, 8 * 2 * q.numel(),
              _ntt_imads(ext, 3, True)),
        _hold(f"ntt Q-split ntt [2^{ext},3]", lambda: ntt.ntt(q, ext),
              lambda: ntt.ntt_plain(q, ext), 20, 2, 8 * 2 * q.numel(),
              _ntt_imads(ext, 3, False)),
        _hold("ntt fold group intt [2^5,3*2^16]", lambda: ntt.intt(grp, 5),
              lambda: ntt.intt_plain(grp, 5), 20, 3, 8 * 2 * grp.numel(),
              _ntt_imads(5, 3 << 16, True)),
    ]
    del x, leaf_x, q, grp

    # Poseidon: one Merkle level of 2^21 digests, a bare permutation at
    # B = 2^20, the first fold tree's [2^16, 96] leaves (four 24-wide
    # chunks of three sponge calls, then two over their digests)
    pairs = rand(n, 8, edge_rows=edge[:, :8])
    st = rand(n, 12, edge_rows=edge)
    leaves = rand(1 << 16, 96, edge_rows=np.tile(edge, (1, 8)))
    pos_cases = [
        _hold(f"poseidon merkle level 2^{ext} digests",
              lambda: poseidon.hash_n(pairs),
              lambda: poseidon.hash_n_plain(pairs), 20, 2,
              8 * (pairs.numel() + pairs.shape[0] * 4),
              POSEIDON_IMADS * pairs.shape[0]),
        _hold(f"poseidon permute B=2^{NBITS}", lambda: poseidon.permute(st),
              lambda: poseidon.permute_plain(st), 20, 2, 8 * 2 * st.numel(),
              POSEIDON_IMADS * st.shape[0]),
        _hold("poseidon fold-tree leaves [2^16,96]",
              lambda: poseidon.hash_leaves(leaves, 96),
              lambda: poseidon.hash_leaves_plain(leaves, 96), 20, 2,
              8 * (leaves.numel() + leaves.shape[0] * 4),
              POSEIDON_IMADS * 14 * leaves.shape[0]),
    ]
    return [dict(cases[0], name=k.name, err=max(c["err"] for c in cases),
                 cases=cases)
            for k, cases in ((kernels.NTT, ntt_cases),
                             (kernels.POSEIDON, pos_cases))]


def main() -> int:
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "eigen_zkvm_tpu_torch")):
        return _fail(f"the port's package is not beside {__file__}")
    sys.path.insert(0, ROOT)
    import numpy as np

    from eigen_zkvm_tpu_torch import bench_chain, kernels
    from eigen_zkvm_tpu_torch.stark.prove import stark_prove
    from eigen_zkvm_tpu_torch.utils.devices import (card_line, cuda_device,
                                                    describe)
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = cuda_device(0)
    report = {"card": card, "device": describe(dev),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # 2. build
    info = kernels.build(force=True)
    kernels.library()
    report["build_s"] = info["seconds"]
    print(f"build: {info['seconds']:.2f} s (nvcc, sm_90a)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.split('info    :')[-1].strip()}")

    # 3. the field primitives against Python integers, the measured IMAD
    # rate, the kernels against their plain versions
    from eigen_zkvm_tpu_torch import kernel_probe
    from eigen_zkvm_tpu_torch.kernels import gl_check

    bad = gl_check.failures(dev)
    report["gl_check_failures"] = bad
    print(f"field primitives (csrc/gl.cuh) on edge and random operands: "
          f"{len(bad)} mismatches")
    if bad:
        return _fail("a device field primitive disagrees with Python "
                     "integers: " + "; ".join(bad[:4]))
    rate = kernel_probe.imad_issue(dev)
    report["imad_wide"] = rate
    print(f"IMAD.WIDE.U32 measured: {rate['imads_per_clock_per_sm']:.2f} a "
          f"clock an SM inside a loop that issues "
          f"{rate['instructions_per_clock_per_sm']:.2f} integer instructions "
          f"a clock an SM at {rate['clock_ghz']:.3f} GHz; the bounds assume "
          f"64 IMADs a clock an SM at 1.98 GHz")
    rng = np.random.default_rng(2024)
    checks = _check_kernels(dev, rng)
    report["kernel_checks"] = checks
    if any(c["err"] != 0.0 for c in checks):
        return _fail("a kernel disagrees with its plain version")

    # 4. the main path: the port's file-based stark_prove, self-verifying
    with tempfile.TemporaryDirectory() as tmp:
        files = bench_chain.write_chain_files(tmp, NBITS, WIDTH, QUERIES)
        zkin = os.path.join(tmp, "proof.json")
        prof = Prof("stark_gen", dev, on=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        try:
            stark_prove(files["stark_struct"], files["pil"], files["const"],
                        files["cm"], zkin_out=zkin, device=dev, prof=prof)
        except RuntimeError as e:
            return _fail(f"the port's prove failed: {e}")
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        launches = kernels.counts()
        with open(zkin, "rb") as f:
            proof_json = f.read()
    peak = torch.cuda.max_memory_allocated(dev)
    t_gen = sum(sec for _, sec in prof.stages)
    digest = hashlib.sha256(proof_json).hexdigest()
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(f"main path: stark_prove on cuda, chain AIR 2^{NBITS} x {WIDTH}")
    for stage, sec in prof.stages:
        print(f"  {stage}: {sec:.3f} s")
    print(f"  stark_gen {t_gen:.3f} s; load + setup + verify "
          f"{t_total - t_gen:.3f} s; total {t_total:.3f} s; peak device "
          f"memory {peak / 2**30:.3f} GiB; launches {launches}")
    print(f"  proof JSON {len(proof_json)} bytes, sha256 {digest}; equal to "
          f"the host engine's: {digest == HOST_PROOF_SHA256}; JAX or JAX-"
          f"package modules loaded: {foreign}")
    report.update(prove_s=t_total, stark_gen_s=t_gen, stages=prof.stages,
                  peak_bytes=peak, launches=launches, verified=True,
                  proof_bytes=len(proof_json), proof_sha256=digest,
                  proof_identical=digest == HOST_PROOF_SHA256,
                  foreign_modules=foreign)
    if any(n == 0 for n in launches.values()):
        return _fail(f"a kernel of the main path never launched: {launches}")
    if digest != HOST_PROOF_SHA256:
        return _fail("the port's proof differs from the host engine's")
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    print(f"report: {json.dumps(report)}")
    by_name = {c["name"]: c for c in checks}
    kernel_lines = [{"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": by_name[k.name]["err"],
                     "ms": by_name[k.name]["ms"],
                     "plain_ms": by_name[k.name]["plain_ms"],
                     "bound_ms": by_name[k.name]["bound_ms"],
                     "bound_by": by_name[k.name]["bound_by"],
                     "library_ms": None}
                    for k in kernels.KERNELS]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernel_lines}))
    print(json.dumps({"ok": True, "device": describe(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
