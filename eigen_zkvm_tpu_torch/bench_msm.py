"""Time the Groth16 prover's elliptic-curve kernels and its Fr transforms of
one tree of the port at the shapes of a Groth16 run, for comparing two
trees in one call.

    python eigen_zkvm_tpu_torch/bench_msm.py --root DIR [--constraints N]
        [--runs 3] [--reps 5]

Imports `eigen_zkvm_tpu_torch` from DIR (a checkout of this repository,
this one or another), so one script times two trees alike.  It builds
bench_groth16's synthetic circuit, runs setup and `--runs` proves through
groth16/api.py with the device drained at every `Prof` tick (the stage
split of setup and of each prove), then times, with CUDA events over
`--reps` launches after a warm-up: the MSM on the prove's A query (G1) and
B2 query (G2) with the witness, the fixed-base batch at setup's G1 and
G2 lane counts on random scalars below 2^253, every fourth one 0, and the
Fr transforms (K3) on random values: `fr_ntt.ntt` at 2^21, forward and
inverse, and the prove's quotient chain at its domain (three
`to_coset`, `quotient`, `from_coset`).  Each prove's K3 launches are in its
`launches`.  Then the prove's R1CS step (K4) over 20 calls on the prove's
own witness: where the tree has `r1cs.Rows`, its one `r1cs.evaluate` call
(one launch into a [3, m, 4] buffer); in an older tree, its three
`r1cs.evaluate` calls with the `torch.zeros` and copies `_witness_h` made
around them.
Only names that every tree of the port has are used, beside that one
test.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

NTT_BITS = 21   # the transform timed alone: the smoke circuit's domain


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _r1cs_step(g16, r1cs, constraints, wit_m, m: int, n_pub: int):
    """The prove's R1CS step as this tree's `_witness_h` runs it."""
    import torch

    if hasattr(r1cs, "Rows"):
        rows = g16._rows(constraints, wit_m.device)
        return lambda: r1cs.evaluate(rows, wit_m, m, n_pub)
    mats = g16._csr(constraints, wit_m.device)
    nc = len(constraints)

    def step():
        abz = []
        for mat in mats:
            full = torch.zeros((m, 4), dtype=torch.int64, device=wit_m.device)
            full[:nc] = r1cs.evaluate(mat, wit_m)
            abz.append(full)
        abz[0][nc : nc + n_pub] = wit_m[:n_pub]
        return abz
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--constraints", type=int, default=(1 << 21) - 3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from eigen_zkvm_tpu_torch import bench_groth16 as bg
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs
    from eigen_zkvm_tpu_torch.utils.devices import card_line, cuda_device
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    dev = cuda_device(0)
    report = {"root": args.root, "card": card_line(),
              "module": os.path.dirname(os.path.abspath(ec.__file__))}
    t0 = time.perf_counter()
    kernels.library()
    report["build_s"] = time.perf_counter() - t0
    circ = bg.synthetic(args.constraints, 2, args.seed)
    prof = Prof("groth16.setup", dev, on=True)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bn128", circ,
                                       rng=bg.seeded(args.seed), device=dev,
                                       prof=prof)
    torch.cuda.synchronize(dev)
    report["setup_s"] = time.perf_counter() - t0
    report["setup_stages"] = prof.stages
    runs = []
    for _ in range(args.runs):
        kernels.reset_counts()
        prof = Prof("groth16.prove", dev, on=True)
        t0 = time.perf_counter()
        proof, pubs = api.groth16_prove_inplace(
            "bn128", circ, pk, rng=bg.seeded(args.seed + 1), prof=prof)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        ok = api.groth16_verify_inplace("bn128", vk, proof, pubs)
        sha = hashlib.sha256(
            api.proof_to_json(proof, "bn128").encode()).hexdigest()
        runs.append({"prove_s": wall, "verified": ok, "sha256": sha,
                     "stages": prof.stages, "launches": kernels.counts()})
        print(f"prove {wall:.3f} s {ok} {sha[:16]}: " + ", ".join(
            f"{s} {t:.3f}" for s, t in prof.stages), flush=True)
    report["runs"] = runs

    wit = bi.to_tensor([int(v) % bg.R for v in circ.w], dev)
    step = _r1cs_step(g16, r1cs, circ.constraints, fr_ntt.to_mont(wit),
                      pk.domain_size, pk.n_public + 1)
    k4_ms = _time_ms(step, 20)
    del step
    k1 = {}
    for g, label, pts in ((ec.G1, "A", pk.a_query),
                          (ec.G2, "B2", pk.b2_query)):
        k1[label] = _time_ms(lambda: ec.msm(g, pts, wit), args.reps)
    n1 = 3 + 2 * pk.n_vars + pk.l_query.shape[0] + pk.n_public + 1 \
        + pk.h_query.shape[0]
    n2 = 3 + pk.n_vars
    m = pk.domain_size
    del pk, vk, wit
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k2 = {}
    for g, label, n in ((ec.G2, "G2", n2), (ec.G1, "G1", n1)):
        S = torch.randint(-2**63, 2**63 - 1, (n, 4), dtype=torch.int64,
                          device=dev, generator=gen)
        S[:, 3] &= (1 << 61) - 1
        S[::4] = 0
        base = ec.generator(g)
        k2[label] = {"lanes": n, "ms": _time_ms(
            lambda: ec.scalar_mul_batch(g, base, S), 2)}
        del S

    def fr_values(log_n):  # canonical: below 2^253 < r
        x = torch.randint(-2**63, 2**63 - 1, (1 << log_n, 4),
                          dtype=torch.int64, device=dev, generator=gen)
        x[:, 3] &= (1 << 61) - 1
        return x

    x = fr_values(NTT_BITS)
    k3 = {f"ntt_2^{NTT_BITS}_ms": _time_ms(
              lambda: fr_ntt.ntt(x, NTT_BITS), 4 * args.reps),
          f"intt_2^{NTT_BITS}_ms": _time_ms(
              lambda: fr_ntt.ntt(x, NTT_BITS, inverse=True), 4 * args.reps)}
    log_m = m.bit_length() - 1
    abc = [fr_values(log_m) for _ in range(3)]
    k = fr_ntt.mont_const(fr_ntt.z_coset_inv(m), dev)
    k3[f"quotient_chain_2^{log_m}_ms"] = _time_ms(
        lambda: fr_ntt.from_coset(fr_ntt.quotient(
            *(fr_ntt.to_coset(v, log_m) for v in abc), k), log_m), args.reps)
    del x, abc
    report.update(k1_ms=k1, k2=k2, k3=k3, k4_step_ms=k4_ms,
                  k3_launches_warm_prove=runs[-1]["launches"]["fr_ntt"],
                  k4_launches_warm_prove=runs[-1]["launches"]["r1cs"],
                  peak_bytes=torch.cuda.max_memory_allocated(dev))
    print(f"K1 A {k1['A']:.3f} ms, B2 {k1['B2']:.3f} ms; K2 G2 "
          f"{k2['G2']['ms']:.3f} ms ({n2} lanes), G1 {k2['G1']['ms']:.3f} ms "
          f"({n1} lanes); setup {report['setup_s']:.3f} s", flush=True)
    print("K3 " + ", ".join(f"{key} {ms:.4f}" for key, ms in k3.items())
          + f"; K3 launches a warm prove {report['k3_launches_warm_prove']}",
          flush=True)
    print(f"K4 the prove's R1CS step {k4_ms:.4f} ms; K4 launches a warm "
          f"prove {report['k4_launches_warm_prove']}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
