"""FRI benchmark of the port on one CUDA device: GF(p^3) against GF(p^5).

For each extension (dim 3, then dim 5) a polynomial of degree < 2^nbits,
its coefficients drawn with numpy from a seed (`coeffs`), is evaluated on
the shifted coset of 2^(nbits + 1) points on the card (`coset_eval`: the
NTT kernel), committed in one Merkle tree of one row a leaf (the Poseidon
kernel) and proved by `stark/fri.prove_pol` with FRI at
`bench_chain.chain_struct(nbits, queries)`.  The two extensions share the
struct, the tree count and the queries, so they differ only in the fold's
field.  (A prove's `fri` stage also answers the queries of its five
trees.)

    python -m eigen_zkvm_tpu_torch.bench_fri --nbits 20 --runs 3

Each run's wall ends in torch.cuda.synchronize(); every proof of a dim must
be byte-identical and the first must verify.  One more run of each dim
under torch.profiler gives its device time (bench_chain.device_time) and
busy share.  The last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

SEED = 55


def coeffs(nbits: int, seed: int, dim: int = 5):
    """A polynomial of degree < 2^nbits over GF(p^dim): its [2^nbits, dim]
    u64 coefficients drawn with numpy from `seed` (tests/test_fri_f5g.py's
    draw)."""
    import numpy as np

    from .ops import gl

    rng = np.random.default_rng(seed)
    return rng.integers(0, gl.P_INT, size=(1 << nbits, dim),
                        dtype=np.uint64)


def coset_eval(cs, nbits: int, nbits_ext: int, device):
    """The evaluation [2^nbits_ext, dim] of coefficients `cs` on the
    shifted coset, through the port's LDE: their values on the 2^nbits
    domain (ntt.ntt), extended by ntt.interpolate."""
    from .ops import gl, ntt

    values = ntt.ntt(gl.from_u64(cs, device), nbits)
    return ntt.interpolate(values, nbits, nbits_ext)


def run(dim: int, nbits: int, queries: int, runs: int, device,
        seed: int = SEED, trace: bool = False) -> dict:
    """`runs` FRI proves of one seeded polynomial over GF(p^dim) (see the
    module docstring), then one more under torch.profiler if `trace`."""
    import torch

    from . import bench_chain, kernels
    from .ops import commit
    from .stark import fri as fri_mod
    from .stark.backends import get_backend

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ss = bench_chain.chain_struct(nbits, queries)
    t0 = time.perf_counter()
    pol = coset_eval(coeffs(nbits, seed, dim), nbits, nbits + 1, device)
    tree = commit.merkelize(pol)
    tree.root()
    sync()
    out = {"dim": dim, "commit_s": time.perf_counter() - t0, "runs": []}
    fri = fri_mod.FRI(ss, get_backend("GL"), dim=dim)

    def prove():
        kernels.reset_counts()
        t0 = time.perf_counter()
        proof = fri_mod.prove_pol(fri, pol, tree)
        sync()
        return proof, time.perf_counter() - t0

    texts = set()
    for i in range(runs):
        proof, wall = prove()
        if i == 0:
            t0 = time.perf_counter()
            out["verified"] = fri_mod.verify_pol(fri, tree.root(), proof)
            out["verify_s"] = time.perf_counter() - t0
        texts.add(fri_mod.proof_json(proof))
        out["runs"].append({"prove_s": wall, "launches": kernels.counts()})
    out["identical"] = len(texts) == 1
    out["sha256"] = sorted(hashlib.sha256(t.encode()).hexdigest()
                           for t in texts)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            _, wall = prove()
        dt = bench_chain.device_time(tp)
        out["trace"] = {"wall_ms": wall * 1e3, "device_ms": dt["device_ms"],
                        "busy_share": dt["device_ms"] / (wall * 1e3),
                        "rows": dt["rows"][:8]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nbits", type=int, default=20)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)

    from . import kernels
    from .utils.devices import card_line, cuda_device

    dev = cuda_device(0)
    report = {"card": card_line(), "nbits": args.nbits,
              "queries": args.queries, "seed": args.seed}
    print(f"card: {report['card']}", flush=True)
    report["build_s"] = kernels.load()["seconds"]
    for dim in (3, 5):
        r = run(dim, args.nbits, args.queries, args.runs, dev, args.seed,
                trace=True)
        report[f"dim{dim}"] = r
        walls = [x["prove_s"] for x in r["runs"]]
        print(f"GF(p^{dim}): commit {r['commit_s']:.3f} s, FRI prove "
              + ", ".join(f"{w:.4f}" for w in walls)
              + f" s, launches {r['runs'][-1]['launches']}; profiled: wall "
              f"{r['trace']['wall_ms']:.3f} ms, device "
              f"{r['trace']['device_ms']:.3f} ms (busy share "
              f"{r['trace']['busy_share']:.4f}); verified {r['verified']}, "
              f"identical {r['identical']}", flush=True)
        for name, ms, n in r["trace"]["rows"]:
            print(f"  {ms:10.3f} ms {n:6d}  {name[:70]}")
    report["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(json.dumps(report), flush=True)
    ok = all(report[f"dim{d}"]["verified"] and report[f"dim{d}"]["identical"]
             for d in (3, 5)) and not report["foreign_modules"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
