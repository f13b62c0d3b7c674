"""A synthetic BN254 R1CS and a warm-prove timer for the port's Groth16.

    python -m eigen_zkvm_tpu_torch.bench_groth16 --constraints 2097149 \\
        --runs 2 --seed 1

The circuit (`synthetic`) is deterministic from its seed (numpy): wire 0 is
the one-wire, wires 1..n_publics the public inputs, then a few random
inputs; every constraint adds one wire.  Half the constraints are
booleanity checks b * b = b of a new wire holding 0 or 1, as a verifier
circuit's bit decompositions are (so the MSM scalars hit the digit-0/1
buckets as real ones do); the other half are gates (sum a)(sum b) =
(sum c) with 1-3 terms a side over earlier wires, the new wire on the C side
with coefficient 1.  Coefficients come from a small pool (1, -1, 2 and a
few constants), as a compiled circuit's do.  Constraints are the JAX
package's {wire: coef} dict triples, so both packages take the same
circuit.

Setup draws from `seeded(seed)` and every prove from `seeded(seed + 1)`,
so every prove writes the same bytes, and the JAX package given the same
draws writes them too.  The timer runs setup once, then `--runs` proves (the first cold: CSR,
twiddle tables, allocator), each verified, and prints per prove the `Prof`
stage split with the device drained at every tick, the kernel launches and
the peak device memory; the last line is one JSON object.  `--trace`
then splits the prove's A (G1) and B2 (G2) MSMs by stage: each is run
again with a `trace` list (ops/ec.msm) and the card's time and the host's
time between the stage boundaries printed (the second of two runs).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import random
import time

import numpy as np
import torch

from .curves import bn254

R = bn254.R
N_RANDOM_INPUTS = 8


class Circuit:
    """What the Groth16 entry points read of a circuit."""

    def __init__(self, constraints, n_vars, n_publics, w):
        self.constraints = constraints
        self.n_vars = n_vars
        self.n_publics = n_publics
        self.w = w
        self.P = R


def synthetic(n_constraints: int, n_publics: int = 2, seed: int = 0
              ) -> Circuit:
    """The synthetic circuit of `n_constraints` rows (module docstring)."""
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    pool = [1, R - 1, 2] + [prng.randrange(R) for _ in range(5)]
    n_in = 1 + n_publics + N_RANDOM_INPUTS
    w = [1] + [prng.randrange(R) for _ in range(n_in - 1)]
    kind = rng.random(n_constraints) < 0.5          # True: booleanity
    bits = rng.integers(0, 2, n_constraints)
    nterms = rng.integers(1, 4, (n_constraints, 3))
    picks = rng.random((n_constraints, 3, 3))
    coefs = rng.integers(0, len(pool), (n_constraints, 3, 3))
    constraints = []
    for j in range(n_constraints):
        new = len(w)
        if kind[j]:
            b = int(bits[j])
            w.append(b)
            constraints.append(({new: 1}, {new: 1}, {new: 1}))
            continue
        sides, vals = [], []
        for side in range(3):
            terms = {}
            for t in range(int(nterms[j, side]) - (side == 2)):
                terms[int(picks[j, side, t] * new)] = pool[coefs[j, side, t]]
            sides.append(terms)
            vals.append(sum(w[s] * c for s, c in terms.items()) % R)
        out = (vals[0] * vals[1] - vals[2]) % R
        w.append(out)
        sides[2][new] = 1
        constraints.append(tuple(sides))
    return Circuit(constraints, len(w), n_publics, w)


# Row lengths of `long_rows`: around the kernel's thread/warp threshold
# (ops/r1cs.SHORT_MAX), and, at fixed strides, a 254-bit weighted sum and a
# 4,096-term row.
LONG_ROW_LENS = (0, 1, 2, 3, 16, 17, 33)


def long_rows(n_rows: int, seed: int = 0) -> Circuit:
    """Rows for K4's warp path (csrc/r1cs.cu), not a satisfiable circuit:
    each side of row j has a length drawn from LONG_ROW_LENS, every 64th
    row 254 terms (a Num2Bits sum) and every 1024th from row 7 on 4,096,
    over a run of consecutive wires from a random start; coefficients 1
    (30 %), -1 (30 %) or random; the witness random below r."""
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    n_vars = n_rows + 4096
    w = [1] + [prng.randrange(R) for _ in range(n_vars - 1)]
    lens = rng.choice(LONG_ROW_LENS, size=(n_rows, 3))
    lens[::64] = 254
    lens[7::1024] = 4096
    starts = rng.integers(0, n_vars, size=(n_rows, 3))
    total = int(lens.sum())
    kind = rng.random(total)
    coefs = [1 if k < 0.3 else R - 1 if k < 0.6 else prng.randrange(R)
             for k in kind]
    constraints, pos = [], 0
    for j in range(n_rows):
        sides = []
        for side in range(3):
            n, s0 = int(lens[j, side]), int(starts[j, side])
            sides.append({(s0 + k) % n_vars: coefs[pos + k]
                          for k in range(n)})
            pos += n
        constraints.append(tuple(sides))
    return Circuit(constraints, n_vars, 0, w)


def check(circuit: Circuit) -> bool:
    """Whether the witness satisfies every constraint."""
    w = circuit.w
    for A, B, C in circuit.constraints:
        a = sum(w[s] * c for s, c in A.items())
        b = sum(w[s] * c for s, c in B.items())
        c = sum(w[s] * c for s, c in C.items())
        if (a * b - c) % R:
            return False
    return True


def seeded(seed: int):
    """A deterministic rng for setup's and prove's draws (the JAX package's
    `rng` argument): nonzero values below r."""
    r = random.Random(seed)
    return lambda: r.randrange(1, R)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--constraints", type=int, default=(1 << 21) - 3)
    ap.add_argument("--publics", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="split the A and B2 MSMs by stage (needs CUDA)")
    args = ap.parse_args(argv)

    import os

    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")
    from . import kernels
    from .groth16 import api
    from .utils.devices import card_line, cuda_device, describe
    from .utils.profiler import Prof

    dev = cuda_device() if args.device is None else torch.device(args.device)
    report = {"constraints": args.constraints, "seed": args.seed}
    if dev.type == "cuda":
        report["card"] = card_line()
        report["device"] = describe(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    circ = synthetic(args.constraints, args.publics, args.seed)
    report["circuit_s"] = time.perf_counter() - t0
    report["n_vars"] = circ.n_vars
    prof = Prof("groth16.setup", dev, on=True)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bn128", circ, rng=seeded(args.seed),
                                       device=dev, prof=prof)
    _sync(dev)
    report["setup_s"] = time.perf_counter() - t0
    report["setup_stages"] = prof.stages
    report["domain"] = pk.domain_size
    runs = []
    for _ in range(args.runs):
        kernels.reset_counts()
        prof = Prof("groth16.prove", dev, on=True)
        t0 = time.perf_counter()
        proof, pubs = api.groth16_prove_inplace(
            "bn128", circ, pk, rng=seeded(args.seed + 1), prof=prof)
        _sync(dev)
        wall = time.perf_counter() - t0
        text = api.proof_to_json(proof, "bn128")
        t1 = time.perf_counter()
        ok = api.groth16_verify_inplace("bn128", vk, proof, pubs)
        runs.append({"prove_s": wall, "verify_s": time.perf_counter() - t1,
                     "verified": ok, "stages": prof.stages,
                     "launches": kernels.counts(),
                     "sha256": hashlib.sha256(text.encode()).hexdigest()})
        print(f"prove {wall:.3f} s, verified {ok}: " + ", ".join(
            f"{s} {t:.3f}" for s, t in prof.stages), flush=True)
    report["runs"] = runs
    if dev.type == "cuda":
        report["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if args.trace and dev.type == "cuda":
        report["msm_trace"] = trace_msms(circ, pk)
    print(json.dumps(report))
    return 0 if all(r["verified"] for r in runs) else 1


def trace_msms(circ: Circuit, pk) -> dict:
    """The prove's A (G1) and B2 (G2) MSMs split by stage on the card:
    {query: [{stage, device_ms, host_ms, ...}]}, from the second of two
    traced runs."""
    from .ops import bigint as bi
    from .ops import ec

    dev = pk.a_query.device
    wit = bi.to_tensor([int(v) % R for v in circ.w], dev)
    out = {}
    for g, label, pts in ((ec.G1, "A", pk.a_query),
                          (ec.G2, "B2", pk.b2_query)):
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tr = []
            ec.msm(g, pts, wit, trace=tr)
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
        stages = ec.stage_times(tr)
        out[label] = {"n": pts.shape[0], "wall_ms": wall, "stages": stages}
        print(f"msm {label} ({g}, n={pts.shape[0]}): {wall:.3f} ms wall",
              flush=True)
        for st in stages:
            extra = {k: v for k, v in st.items()
                     if k not in ("stage", "device_ms", "host_ms")}
            print(f"  {st['stage']}: card {st['device_ms']:.3f} ms, host "
                  f"{st['host_ms']:.3f} ms {extra or ''}", flush=True)
    return out


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    raise SystemExit(main())
