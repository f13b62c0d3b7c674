"""The gnark bridge at full width: a BN254 Groth16 proof verified inside a
BLS12-381 circuit (recursion/gnark_bridge.py: about 7.84 M constraints,
domain 2^23) and that circuit proved through the command line's bls_wrap
on the card.  The port's counterpart of the JAX package's
scripts/bench_gnark_wrap.py (reference: recursion-gnark/ffi/go/eigen/
recursion.go:30-82).

    python -m eigen_zkvm_tpu_torch.bench_bridge [--inner DIR] [--device cpu]

The inner proof is `toy_inner`'s (tests/test_gnark_bridge.py's toy
circuit, 2 publics, seeded draws), or the BN254 vk.json, proof.json and
public.json in `--inner DIR` (the CLI's JSON).  The inner proof's size does
not change the circuit: its shape is set by the inner vk (one pairing
check and the MSM over the publics).  `cli.main(["bls_wrap", ...,
"--reuse_setup"])` builds the circuit, sets it up, proves and verifies on
the card with the draws of `seeded(OUTER_SEED)` (setup's first), keeping
the outer key in a temporary directory.  Printed: the `Prof` split
(build; setup's qap and fixed-base batches; prove's witness, csr, r1cs
eval, ntts, MSMs A, B2, B1, L, H; verify), the kernels' launches, peak
device memory and peak host RSS, the verify of a changed public (False),
and the outer vk, proof and public JSON on lines of their own
("outer vk.json: ..."), so that the JAX package's groth16.verify can
check the card's proof on a CPU.  Then, on the card, the four BLS12-381
kernels at the bridge's shapes against their plain versions,
exactly, with chip_smoke.py's `_hold` and bound pricing: K1 on the prove's
A (G1) and B2 (G2) queries with the witness (the key reloaded from its
file, the circuit built again for its witness) against
ec.msm_stages_plain; K2 at setup's lane counts on random scalars (plain
on one lane in 256 of G1, 64 of G2); K3 forward, inverse and the coset
round trip at the domain against ntt_plain; K4 on the circuit's three
matrices.  The last line is one JSON object.

`bridge_part` is the part of the bridge that chip_smoke.py's phase 15
proves: build_verifier_circuit's calls up to the residue check's
c * c^-1 = 1, without B's on-curve and subgroup checks and the Miller
loop.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import torch

from .bench_groth16 import seeded
from .curves import bls12_381 as bls
from .curves import bn254 as bn
from .recursion.circuit import CircuitBuilder

# the inner BN254 proof's draws: setup from seeded(INNER_SEED), prove from
# seeded(INNER_SEED + 1)
INNER_SEED = 3
# the outer BLS12-381 draws: bls_wrap's setup and prove from one
# seeded(OUTER_SEED) stream; chip_smoke.py's bridge_part: setup from
# seeded(OUTER_SEED), prove from seeded(OUTER_SEED + 1)
OUTER_SEED = 1
INNER_FILES = ("vk.json", "proof.json", "public.json")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_inner(device=None):
    """The inner BN254 Groth16 proof of tests/test_gnark_bridge.py's
    `_toy_inner_proof` (x y = 35, x + y = 12 with x = 5, y = 7; both
    outputs public) set up and proved on `device` with seeded draws:
    (vk, proof, publics)."""
    from .groth16 import groth16 as g16

    b = CircuitBuilder(prime=bn.R)
    out1 = b.public(35)
    out2 = b.public(12)
    x = b.wire(b.sig(5))
    y = b.wire(b.sig(7))
    b.assert_eq(b.mul(x, y), out1)
    b.assert_eq(x + y, out2)
    pk, vk = g16.setup(b.constraints, b.n_vars, b.n_publics,
                       rng=seeded(INNER_SEED), device=device)
    proof, pubs = g16.prove(pk, b.constraints, b.w,
                            rng=seeded(INNER_SEED + 1))
    if not g16.verify(vk, proof, pubs):
        raise RuntimeError("the inner proof does not verify")
    return vk, proof, pubs


def write_inner(directory: str, vk, proof, publics):
    """The inner vk, proof and publics as the CLI's JSON files."""
    from .groth16 import api

    texts = (api.vk_to_json(vk), api.proof_to_json(proof, "bn128"),
             api.publics_to_json(publics))
    for name, text in zip(INNER_FILES, texts):
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)


def read_inner(directory: str):
    """(vk, proof, publics) of the CLI's JSON files in `directory`."""
    from .groth16 import api

    texts = []
    for name in INNER_FILES:
        with open(os.path.join(directory, name)) as f:
            texts.append(f.read())
    return (api.vk_from_json(texts[0]), api.proof_from_json(texts[1]),
            api.publics_from_json(texts[2]))


def bridge_part(vk, proof, publics) -> CircuitBuilder:
    """The bridge's calls up to the residue check's c * c^-1 = 1, in
    build_verifier_circuit's order (recursion/gnark_bridge.py): the host
    residue witness, the public wires, A, B and C as inputs, A and C on
    the curve, the fixed-base MSM over vk.ic, c and c^-1 as inputs and
    their product asserted 1.  Left out: B's on-curve and subgroup checks
    and everything from one_hot_w27 on (the Miller loop)."""
    from .recursion.gnark_bridge import _msm_fixed_base, inner_residue
    from .recursion.pairing_circuit import PairingCircuit

    b = CircuitBuilder(prime=bls.R)
    pub_vals = [int(x) % bn.R for x in publics]
    ic_val, _, c_val, _ = inner_residue(vk, proof, pub_vals)
    pub_wires = [b.public(v) for v in pub_vals]
    pc = PairingCircuit(b)
    A = pc.g1_input(proof.a)
    pc.g2_input(proof.b)
    C = pc.g1_input(proof.c)
    pc.g1_assert_on_curve(A)
    pc.g1_assert_on_curve(C)
    ic = _msm_fixed_base(pc, vk.ic, pub_wires, pub_vals)
    assert pc.g1_val(ic) == ic_val
    c_elem = pc.f12_input(c_val)
    c_inv_elem = pc.f12_input(bn.f12_inv(c_val))
    pc.f12_mul_assert_const(c_elem, c_inv_elem, bn.F12_ONE)
    return b


def _smoke():
    """chip_smoke.py of this checkout: its `_hold` and bound pricing."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def holds(dev, circuit, pk) -> dict:
    """The four BLS12-381 kernels at the bridge's shapes against their
    plain versions (module docstring).  {kernel name: cases}."""
    from . import kernels
    from .groth16 import groth16 as g16
    from .ops import bigint as bi
    from .ops import ec, fr_ntt, r1cs

    sm = _smoke()
    R, F = bls.R, bi.FR_BLS
    G1, G2 = ec.G1_BLS, ec.G2_BLS

    def pt_bytes(g):   # bytes of one affine point
        return 16 * g.field.words * g.deg

    wit = bi.to_tensor([int(v) % R for v in circuit.w], dev)
    k1 = []
    for g, label, pts in ((G1, "A", pk.a_query), (G2, "B2", pk.b2_query)):
        n = pts.shape[0]
        k1.append(sm._hold(
            f"msm {g} {label} query, the bridge prove's inputs: n={n}, "
            f"c={ec.window_bits(n)} (plain stages)",
            lambda: ec.msm(g, pts, wit),
            lambda: ec.msm_stages_plain(g, pts, wit), 3, 0,
            n * (32 + pt_bytes(g)) + pt_bytes(g),
            sm._msm_products(pts, wit, g.deg == 2, 255) * sm.IMAD_BLS_FQ))
    del wit

    n1 = 3 + 2 * pk.n_vars + pk.l_query.shape[0] + pk.n_public + 1 \
        + pk.h_query.shape[0]
    n2 = 3 + pk.n_vars
    k2 = []
    for g, n, step in ((G2, n2, 64), (G1, n1, 256)):
        S = sm._random_scalars(dev, n, n, R)
        gen = ec.generator(g)
        rows = slice(0, n, step)
        k2.append(sm._hold(
            f"ec_batch {g} {n} lanes (the bridge setup's count), plain on "
            f"one lane in {step}", lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(g, gen, S[rows]), 2, 0,
            n * 32 + n * pt_bytes(g),
            sm._fixed_base_products(S, g.deg == 2) * sm.IMAD_BLS_FQ,
            rows=rows))
        del S

    m = pk.domain_size
    log_m = m.bit_length() - 1
    x = sm._random_scalars(dev, m, m + 1, R)   # canonical: Montgomery words
    prods = (m // 2) * log_m * sm.IMAD_BN254
    passes = fr_ntt.plan(log_m)
    k3 = [
        sm._hold(f"fr_ntt Fr381 2^{log_m} (passes {passes})",
                 lambda: fr_ntt.ntt(x, log_m, field=F),
                 lambda: fr_ntt.ntt_plain(x, log_m, field=F), 5, 0, 64 * m,
                 prods),
        sm._hold(f"fr_ntt Fr381 inverse 2^{log_m}",
                 lambda: fr_ntt.ntt(x, log_m, inverse=True, field=F),
                 lambda: fr_ntt.ntt_plain(x, log_m, inverse=True, field=F), 5,
                 0, 64 * m, prods),
        sm._hold(f"fr Fr381 coset round trip 2^{log_m}",
                 lambda: fr_ntt.from_coset(fr_ntt.to_coset(x, log_m, field=F),
                                           log_m, field=F),
                 lambda: fr_ntt.from_coset_plain(
                     fr_ntt.to_coset_plain(x, log_m, field=F), log_m,
                     field=F), 5, 0, 64 * m,
                 3 * prods + 2 * m * sm.IMAD_BN254)]
    del x

    rows = g16.r1cs_rows(circuit.constraints, dev, F)
    wit = fr_ntt.to_mont(bi.to_tensor([int(v) % R for v in circuit.w], dev),
                         field=F)
    n_pub = pk.n_public + 1
    k4 = [sm._hold(
        f"r1cs Fr381 the bridge's A, B, C: 3 x {rows.nc} rows, {rows.nnz} "
        f"nonzeros ({3 * rows.nc - rows.n_short} rows on a warp), "
        f"{rows.coefs.shape[0]} coefficients, domain {m}",
        lambda: r1cs.evaluate(rows, wit, m, n_pub),
        lambda: r1cs.evaluate_plain(rows, wit, m, n_pub), 10, 1,
        *sm._r1cs_work(rows, wit, m))]
    return {kernels.MSM_BLS.name: k1, kernels.EC_BATCH_BLS.name: k2,
            kernels.FR_NTT_BLS.name: k3, kernels.R1CS_BLS.name: k4}


def _peak_rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inner", default=None,
                    help="a directory of the inner BN254 vk.json, proof.json "
                         "and public.json (default: toy_inner's proof)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions (default: "
                         "the current CUDA device)")
    args = ap.parse_args(argv)

    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")
    from . import cli, kernels
    from .groth16 import api
    from .groth16 import groth16 as g16
    from .recursion.gnark_bridge import build_verifier_circuit
    from .utils.devices import card_line
    from .utils.profiler import Prof

    dev = g16.resolve_device(args.device)
    cuda = dev.type == "cuda"
    res = {"device": str(dev)}
    if cuda:
        res["card"] = card_line()
        print(f"card: {res['card']}", flush=True)
        info = kernels.load()
        res["build_s"] = info["seconds"]
        print(f"build: {info['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    inner = read_inner(args.inner) if args.inner else toy_inner(dev)
    res["inner_s"] = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="bench_bridge_")
    try:
        write_inner(work, *inner)
        out = os.path.join(work, "wrap")
        argv_wrap = ["bls_wrap", "--vk", os.path.join(work, "vk.json"),
                     "--proof", os.path.join(work, "proof.json"),
                     "--public_input", os.path.join(work, "public.json"),
                     "--output_dir", out, "--reuse_setup"]
        if not cuda:
            argv_wrap += ["--device", "cpu"]
        prof = Prof("bls_wrap", dev, on=True)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv_wrap, prof=prof, rng=seeded(OUTER_SEED))
        res["bls_wrap_s"] = time.perf_counter() - t0
        res["launches"] = kernels.counts()
        res["stages"] = prof.stages
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) \
            if cuda else None
        res["peak_rss_bytes"] = _peak_rss()
        texts = {}
        for name in ("wrap_vk.json", "wrap_proof.json", "wrap_public.json"):
            with open(os.path.join(out, name)) as f:
                texts[name] = f.read()
        ovk = api.vk_from_json(texts["wrap_vk.json"])
        oproof = api.proof_from_json(texts["wrap_proof.json"])
        opubs = api.publics_from_json(texts["wrap_public.json"])
        t0 = time.perf_counter()
        res["verified"] = g16.verify(ovk, oproof, opubs)
        res["verify_s"] = time.perf_counter() - t0
        changed = [(opubs[0] + 1) % bls.R] + opubs[1:]
        res["changed_public_verified"] = g16.verify(ovk, oproof, changed)
        res["rc"] = rc
        res["publics"] = [str(v) for v in opubs]
        print(f"bls_wrap: exit {rc}, {res['bls_wrap_s']:.1f} s; verified "
              f"{res['verified']}, a changed public verified "
              f"{res['changed_public_verified']}", flush=True)
        for stage, sec in prof.stages:
            print(f"  {stage}: {sec:.3f} s")
        print(f"  launches {res['launches']}; peak device memory "
              + (f"{res['peak_device_bytes'] / 2**30:.3f} GiB"
                 if cuda else "n/a")
              + f"; peak host RSS {res['peak_rss_bytes'] / 2**30:.3f} GiB",
              flush=True)
        for name, text in texts.items():
            print(f"outer {name[5:]}: {json.dumps(json.loads(text))}")
        if cuda:
            t0 = time.perf_counter()
            pk = api.load_pk(os.path.join(out, "wrap_pk.bin"), dev)
            res["load_pk_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            circuit = build_verifier_circuit(*inner)
            res["rebuild_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            cases = holds(dev, circuit, pk)
            res["holds_s"] = time.perf_counter() - t0
            del circuit, pk
            res["holds"] = {k: [{key: c[key] for key in (
                "label", "ms", "plain_ms", "bound_ms", "bound_by", "err")}
                for c in cs] for k, cs in cases.items()}
            res["holds_exact"] = all(c["err"] == 0.0 for cs in cases.values()
                                     for c in cs)
            print(f"holds: {res['holds_s']:.1f} s (key load "
                  f"{res['load_pk_s']:.1f} s, circuit rebuilt "
                  f"{res['rebuild_s']:.1f} s); exact {res['holds_exact']}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ok = (res["rc"] == 0 and res["verified"]
          and not res["changed_public_verified"]
          and res.get("holds_exact", True))
    res["ok"] = ok
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
