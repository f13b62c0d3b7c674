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
              Then the BN254 field primitives (csrc/bn254.cuh: Fq, Fr and Fq2
              add, sub, mul, sqr, inv) against Python ints on their edge
              operands (0, 1, q - 1, q - 2, R mod q) and 2^20 random pairs
              (2^16 for the Fq2 ones), and three Groth16 kernels against
              their plain versions, exactly: the MSM (csrc/msm.cu, against
              ec_jax's double-and-add in ops/ec.msm_plain) in G1 and G2 at
              n = 2^16 with infinity points, a duplicated point,
              scalars 0, 1 and r - 1 and a hot bucket; the fixed-base batch
              (csrc/ec_batch.cu) at 2^16 lanes in G1 and G2; the Fr NTT
              (csrc/fr_ntt.cu) at 2^21 and 2^16, and at 2^21 its pointwise
              products (by a table, by a constant, the quotient).
  4. prove    the chain AIR of scripts/bench_big.py at 2^20 rows x 8 columns
              (blowup 2, 8 queries), written to files and proved through the
              port's file-based stark_prove on the card, device-resident
              (commits, constraint VM, Q split, openings, FRI folds), which
              verifies its proof: stage split, peak device memory, kernel
              launch counts.  The proof JSON's sha256 must equal
              HOST_PROOF_SHA256, the digest of eigen_zkvm_tpu's host-engine
              proof of the same files.  No module of JAX or of the JAX
              package (eigen_zkvm_tpu) may have been loaded.
  5. groth16  bench_groth16's synthetic BN254 R1CS of 2^21 - 3 constraints
              and 2 publics (domain 2^21, about 2^21 wires, half of them
              boolean) through groth16_setup_inplace, groth16_prove_inplace
              and groth16_verify_inplace on the card: the verifier accepts,
              and the proof JSON's sha256 must equal GROTH16_HOST_SHA256,
              the digest of eigen_zkvm_tpu's host-engine proof of the same
              circuit with the same draws.  Then the kernels at the shapes
              this run gave them: the MSM on the prove's own inputs (the A
              query in G1 and the B2 query in G2, with the witness: about
              2^21 points, c = 14, half the scalars boolean) against the
              plain versions of its stages (ops/ec.msm_stages_plain); the
              fixed-base batch at setup's lane counts (G2 whole, G1 checked
              on one lane in 32); the R1CS rows (csrc/r1cs.cu) of the
              circuit's three matrices.  These cases are the ones the
              kernels' line reports.

Phase 3 holds each kernel at every shape the main path gives it: the NTT
at the LDE of a section, a leaf tile, the Q split's iNTT and NTT and the
FRI fold's group iNTT; Poseidon at a Merkle level, a bare permutation and
a fold tree's 96-wide leaves (the sponge calls that chain a capacity).
Each path's kernels must launch in its own run (counts set to 0 just
before it, read just after): the GL kernels in phase 4, the four Groth16
kernels in phase 5.

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and the IMADs its function needs at the least
over the card's peak IMAD rate (constants below).  The IMADs are counted
from the function and this run's data, not from the kernel: its field
products (butterflies and scales of a radix-2 transform, the S-boxes and
linear layers of the Poseidon opt schedule), each priced at the fewest
32-bit multiply-adds the ISA allows for it.  A BN254 product is priced at
2 * 8^2 = 128 (the 8x8 limb products of a*b and of the Montgomery
reduction); a mixed addition at 11 products (7M + 4S; 33 Fq products in
G2).  An MSM needs, at the least over c, one mixed addition for each
nonzero c-bit digit of a finite point's scalar and 2^(c+1) a window for
the bucket reduction; a fixed-base lane one for each nonzero 8-bit digit
after its first, and 7 products for its affine result; a transform
(m/2) log2 m products; the R1CS one product a nonzero.  No single PyTorch
call computes a Goldilocks NTT, a Poseidon permutation, a BN254 MSM or an
Fr NTT, so `library_ms` is null.

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
G16_CONSTRAINTS, G16_SEED = (1 << 21) - 3, 1
# phase 3's shapes: the MSM's and fixed-base batch's edge cases, the Fr
# transforms (the prove's size first)
G16_CHECK_N, G16_CHECK_NTT_BITS = 1 << 16, (21, 16)
# sha256 of the proof JSON that eigen_zkvm_tpu's host engine writes for this
# chain AIR (its file-based stark_prove, from the files that
# bench_chain.write_chain_files writes).  The CUDA test
# tests/test_torch_prove.py::test_port_on_the_card_matches_host_engine_at_smoke_size
# proves both engines at this size and holds both to this digest.
HOST_PROOF_SHA256 = \
    "7d6bf093c6afc7d4f4467d3fbc27701343f67b291fab11508b7519964610390b"
# sha256 of the proof JSON that eigen_zkvm_tpu's host engine (its native
# C++ path) writes for bench_groth16.synthetic(G16_CONSTRAINTS, 2, G16_SEED)
# with setup drawing from bench_groth16.seeded(G16_SEED) and prove from
# seeded(G16_SEED + 1).  The CUDA test
# tests/test_torch_groth16.py::test_port_on_the_card_and_host_engine_match_the_pinned_digest
# proves both packages at this size and holds both to this digest.
GROTH16_HOST_SHA256 = \
    "0d7d09965b7893d2627396be998b577f2f85777eb156b3e273a1d5c94c2247a4"
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
# Fewest IMADs for one BN254 Montgomery product (Fq or Fr): 8x8 limb
# products for a*b and 8x8 for the reduction's m*q
IMAD_BN254 = 2 * 8 * 8
MADD_PRODUCTS = 11   # madd-2007-bl: 7M + 4S


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


def _timed_once(fn):
    """One call of fn and its time from CUDA events (for plain versions that
    take seconds: no warm-up run)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _hold(label: str, kernel, plain, reps: int, plain_reps: int,
          nbytes: float, imads: float, rows=None) -> dict:
    """One shape of a kernel: its result against the plain version's on
    the same inputs, both times, its bound.  plain_reps = 0 times the one
    plain call that gives the result.  With `rows`, the plain version
    computes those rows of the kernel's result only (lanes that do not
    interact), and its time is for them."""
    got = kernel()
    if rows is not None:
        got = got[rows]
    if plain_reps:
        want = plain()
        plain_ms = _time_ms(plain, plain_reps)
    else:
        want, plain_ms = _timed_once(plain)
    err = _max_abs_err(got, want)
    del got, want
    ms = _time_ms(kernel, reps)
    b = _bound(nbytes, imads)
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
          f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), "
          f"max_abs_err {err}", flush=True)
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


def _check_kernels(dev, rng) -> dict:
    """Phase 3: each GL kernel against its plain version at the main path's
    shapes.  {kernel name: cases}; the first case of a kernel is the one its
    line reports, its error the largest over all its cases."""
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
    return {kernels.NTT.name: ntt_cases, kernels.POSEIDON.name: pos_cases}


def _msm_products(points, scalars, g2: bool) -> int:
    """Fq products of the least bucket-method MSM of these inputs: min over
    c of the mixed additions it needs, one for each nonzero c-bit digit of a
    finite point's scalar (the kernel's entries) and 2^(c+1) for each
    window's bucket reduction, at 11 products each (33 in G2)."""
    from eigen_zkvm_tpu_torch.ops import ec

    live = scalars[~(points.flatten(1) == 0).all(1)]
    adds = min(sum(int((ec.digits(part, c) != 0).sum())
                   for part in live.split(1 << 19))
               + -(-254 // c) * (1 << (c + 1)) for c in range(1, 25))
    return adds * MADD_PRODUCTS * (3 if g2 else 1)


def _fixed_base_products(scalars, g2: bool) -> int:
    """Fq products of the least fixed-base multiply over 8-bit window
    tables: for a lane with a nonzero scalar, one mixed addition (11
    products) for each nonzero 8-bit digit after its first, and 7 for the
    affine result (3 a lane of a batch inversion, then x/Z^2 and y/Z^3);
    3 Fq products an Fq2 product in G2."""
    from eigen_zkvm_tpu_torch.ops import ec

    total = 0
    for part in scalars.split(1 << 20):
        nz = (ec.digits(part, 8) != 0).sum(1)
        total += int((nz - 1).clamp(min=0).sum()) * MADD_PRODUCTS \
            + int((nz > 0).sum()) * 7
    return total * (3 if g2 else 1)


def _random_scalars(dev, n: int, seed: int):
    """n scalars below 2^253 < r made on the card, with 0, 1, 2 and r - 1
    first and every fourth of the rest 0 (the wires a query leaves out)."""
    import torch

    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    S = torch.randint(-2**63, 2**63 - 1, (n, 4), dtype=torch.int64,
                      device=dev, generator=gen)
    S[:, 3] &= (1 << 61) - 1
    S[4::4] = 0
    S[:4] = bi.to_tensor([0, 1, 2, bn254.R - 1], dev)
    return S


def _check_groth16_kernels(dev, rng) -> dict:
    """Phase 3, second half: K1 and K2 at 2^16 with edge inputs (K1
    against ec_jax's double-and-add), K3 at the prove's 2^21 and at 2^16;
    phase 5 holds K1, K2 and K4 at the prove's and setup's own shapes.
    {kernel name: cases}."""
    import random

    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt

    R = bn254.R
    prng = random.Random(int(rng.integers(1 << 30)))
    n = G16_CHECK_N

    def scalars(count):
        return [prng.randrange(R) for _ in range(count)]

    # K2 first: it also makes the MSM's points
    k2_cases, points = [], {}
    for g, label in ((ec.G1, "G1"), (ec.G2, "G2")):
        S = bi.to_tensor([0, 1, 2, R - 1] + scalars(n - 4), dev)
        gen = ec.generator(g)
        k2_cases.append(_hold(
            f"ec_batch {label} {n} lanes",
            lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(g, gen, S), 3, 0,
            n * 32 + n * 64 * g.deg,
            _fixed_base_products(S, g.deg == 2) * IMAD_BN254))
        points[label] = ec.scalar_mul_batch(g, gen, bi.to_tensor(
            [prng.randrange(1, R) for _ in range(n)], dev))

    # K1 against ec_jax's double-and-add: infinity points, a duplicated
    # point, scalars 0, 1 and r - 1, a hot bucket (a quarter of the scalars
    # 1, a quarter 0)
    k1_cases = []
    for g, label in ((ec.G1, "G1"), (ec.G2, "G2")):
        pts = points[label].clone()
        pts[5] = 0
        pts[100:103] = 0
        pts[9] = pts[8]
        ks = scalars(n)
        ks[0], ks[1], ks[2] = 0, 1, R - 1
        for i in range(10, n // 2):
            ks[i] = i & 1
        S = bi.to_tensor(ks, dev)
        k1_cases.append(_hold(
            f"msm {label} n={n} (double-and-add)", lambda: ec.msm(g, pts, S),
            lambda: ec.msm_plain(g, pts, S), 5, 0,
            n * (32 + 64 * g.deg) + 64 * g.deg,
            _msm_products(pts, S, g.deg == 2) * IMAD_BN254))

    # K3: the prove's transforms at 2^21 and 2^16; at 2^21 the pointwise
    # products of to_coset / from_coset (a full table, one constant) and
    # the quotient
    k3_cases = []
    for log_n in G16_CHECK_NTT_BITS:
        m = 1 << log_n
        x = bi.mont_ints(bi.FR, scalars(m), dev)
        prods = (m // 2) * log_n * IMAD_BN254
        k3_cases.append(_hold(
            f"fr_ntt 2^{log_n}", lambda: fr_ntt.ntt(x, log_n),
            lambda: fr_ntt.ntt_plain(x, log_n), 10, 1, 64 * m, prods))
        k3_cases.append(_hold(
            f"fr_ntt inverse 2^{log_n}",
            lambda: fr_ntt.ntt(x, log_n, inverse=True),
            lambda: fr_ntt.ntt_plain(x, log_n, inverse=True), 10, 1,
            64 * m, prods))
        if log_n != G16_CHECK_NTT_BITS[0]:
            continue
        tab = fr_ntt.coset_scale(log_n, False, dev)
        k = fr_ntt.mont_const(fr_ntt.z_coset_inv(m), dev)
        k3_cases += [
            _hold(f"fr mul 2^{log_n} by a table", lambda: fr_ntt.mul(x, tab),
                  lambda: fr_ntt.mul_plain(x, tab), 10, 1, 3 * 32 * m,
                  m * IMAD_BN254),
            _hold(f"fr mul 2^{log_n} by a constant",
                  lambda: fr_ntt.mul(x, k), lambda: fr_ntt.mul_plain(x, k),
                  10, 1, 2 * 32 * m, m * IMAD_BN254),
            _hold(f"fr quotient 2^{log_n}",
                  lambda: fr_ntt.quotient(x, x, x, k),
                  lambda: fr_ntt.quotient_plain(x, x, x, k), 10, 1,
                  4 * 32 * m, 2 * m * IMAD_BN254)]
    return {kernels.MSM.name: k1_cases, kernels.EC_BATCH.name: k2_cases,
            kernels.FR_NTT.name: k3_cases}


def _check_groth16_shapes(dev, circ, pk) -> dict:
    """Phase 5, after the run: K1 on the prove's own inputs (the A query
    in G1 and the B2 query in G2 with the witness) against the plain
    versions of its stages, K2 at setup's lane counts (the G2 batch whole,
    the G1 batch on one lane in 32), K4 on the circuit's three matrices.
    {kernel name: cases}; the first case of each is the one its line
    reports."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs

    wit = bi.to_tensor([int(v) % bn254.R for v in circ.w], dev)
    k1_cases = []
    for g, label, pts in ((ec.G1, "A", pk.a_query),
                          (ec.G2, "B2", pk.b2_query)):
        n = pts.shape[0]
        k1_cases.append(_hold(
            f"msm {g} {label} query, the prove's inputs: n={n}, "
            f"c={ec.window_bits(n)} (plain stages)",
            lambda: ec.msm(g, pts, wit),
            lambda: ec.msm_stages_plain(g, pts, wit), 3, 0,
            n * (32 + 64 * g.deg) + 64 * g.deg,
            _msm_products(pts, wit, g.deg == 2) * IMAD_BN254))
    del wit

    n1 = 3 + 2 * pk.n_vars + pk.l_query.shape[0] + pk.n_public + 1 \
        + pk.h_query.shape[0]
    n2 = 3 + pk.n_vars
    k2_cases = []
    for g, n, step in ((ec.G2, n2, 1), (ec.G1, n1, 32)):
        S = _random_scalars(dev, n, n)
        gen = ec.generator(g)
        rows = None if step == 1 else slice(0, n, step)
        k2_cases.append(_hold(
            f"ec_batch {g} {n} lanes (setup's count)"
            + ("" if rows is None else f", plain on one lane in {step}"),
            lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(
                g, gen, S if rows is None else S[rows]), 2, 0,
            n * 32 + n * 64 * g.deg,
            _fixed_base_products(S, g.deg == 2) * IMAD_BN254, rows=rows))
        del S

    mats = r1cs.build(circ.constraints, dev)
    wit = fr_ntt.to_mont(bi.to_tensor(circ.w, dev))
    k4_cases = []
    for mat, label in zip(mats, "ABC"):
        nnz = mat.wires.numel()
        k4_cases.append(_hold(
            f"r1cs {label} {mat.rows} rows, {nnz} nonzeros",
            lambda: r1cs.evaluate(mat, wit),
            lambda: r1cs.evaluate_plain(mat, wit), 10, 1,
            8 * (mat.rows + 1) + 16 * nnz + 32 * mat.coefs.shape[0]
            + 32 * wit.shape[0] + 32 * mat.rows, nnz * IMAD_BN254))
    return {kernels.MSM.name: k1_cases, kernels.EC_BATCH.name: k2_cases,
            kernels.R1CS.name: k4_cases}


def _groth16(dev, circ) -> dict:
    """Phase 5: setup, prove and verify through the api entry points, the
    kernels' counts set to 0 before setup and read after verify.  (numbers,
    proving key)"""
    from eigen_zkvm_tpu_torch import bench_groth16 as bg
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    setup_prof = Prof("groth16.setup", dev, on=True)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bn128", circ,
                                       rng=bg.seeded(G16_SEED), device=dev,
                                       prof=setup_prof)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof = Prof("groth16.prove", dev, on=True)
    proof, pubs = api.groth16_prove_inplace(
        "bn128", circ, pk, rng=bg.seeded(G16_SEED + 1), prof=prof)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok = api.groth16_verify_inplace("bn128", vk, proof, pubs)
    t3 = time.perf_counter()
    launches = kernels.counts()
    text = api.proof_to_json(proof, "bn128").encode()
    return dict(setup_s=t1 - t0, prove_s=t2 - t1, verify_s=t3 - t2,
                setup_stages=setup_prof.stages, stages=prof.stages,
                verified=ok, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                domain=pk.domain_size, n_vars=circ.n_vars,
                proof_sha256=hashlib.sha256(text).hexdigest()), pk


def main() -> int:
    t_start = time.perf_counter()
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
    cases = _check_kernels(dev, rng)
    from eigen_zkvm_tpu_torch import bench_groth16
    from eigen_zkvm_tpu_torch.kernels import bn254_check

    bad = bn254_check.failures(dev)
    report["bn254_check_failures"] = bad
    print(f"field primitives (csrc/bn254.cuh: Fq, Fr, Fq2) on edge and "
          f"random operands: {len(bad)} mismatches")
    if bad:
        return _fail("a BN254 device field primitive disagrees with Python "
                     "ints: " + "; ".join(bad[:4]))
    cases.update(_check_groth16_kernels(dev, rng))
    if any(c["err"] != 0.0 for cs in cases.values() for c in cs):
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
    gl_kernels = (kernels.NTT, kernels.POSEIDON)
    if any(launches[k.name] == 0 for k in gl_kernels):
        return _fail(f"a kernel of the main path never launched: {launches}")
    if digest != HOST_PROOF_SHA256:
        return _fail("the port's proof differs from the host engine's")

    # 5. Groth16 at 2^21 through the api entry points
    t0 = time.perf_counter()
    circ = bench_groth16.synthetic(G16_CONSTRAINTS, 2, G16_SEED)
    report["groth16_circuit_s"] = time.perf_counter() - t0
    g16, pk = _groth16(dev, circ)
    print(f"groth16: {G16_CONSTRAINTS} constraints, {g16['n_vars']} wires, "
          f"domain 2^{g16['domain'].bit_length() - 1}; setup "
          f"{g16['setup_s']:.3f} s, prove {g16['prove_s']:.3f} s, verify "
          f"{g16['verify_s']:.3f} s ({g16['verified']}); peak device memory "
          f"{g16['peak_bytes'] / 2**30:.3f} GiB; launches {g16['launches']}")
    for stage, sec in g16["setup_stages"] + g16["stages"]:
        print(f"  {stage}: {sec:.3f} s")
    print(f"  proof sha256 {g16['proof_sha256']}; equal to the host "
          f"engine's: {g16['proof_sha256'] == GROTH16_HOST_SHA256}")
    report["groth16"] = g16
    for k in kernels.KERNELS:
        if k not in gl_kernels:
            launches[k.name] = g16["launches"][k.name]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if not g16["verified"]:
        return _fail("the port's Groth16 proof does not verify")
    if any(launches[k.name] == 0 for k in kernels.KERNELS):
        return _fail(f"a kernel of its path never launched: {launches}")
    if g16["proof_sha256"] != GROTH16_HOST_SHA256:
        return _fail("the port's Groth16 proof differs from the host "
                     "engine's")
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")
    # the kernels at the shapes this run gave them, reported first
    for name, more in _check_groth16_shapes(dev, circ, pk).items():
        cases[name] = more + cases.get(name, [])
    del pk
    checks = [dict(cs[0], name=name, err=max(c["err"] for c in cs),
                   cases=cs) for name, cs in cases.items()]
    report["kernel_checks"] = checks
    if any(c["err"] != 0.0 for c in checks):
        return _fail("a kernel disagrees with its plain version at the "
                     "Groth16 run's shapes")

    report["smoke_s"] = time.perf_counter() - t_start
    print(f"smoke: {report['smoke_s']:.1f} s, kernel build included")
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
