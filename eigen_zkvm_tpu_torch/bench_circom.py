"""circom circuits through the port on one CUDA device: compile, simplify,
write, prove.

    python -m eigen_zkvm_tpu_torch.bench_circom [--n N] [--device cpu]

The circuits are circom sources in the compiler's subset (dsl/circom.py),
committed under data/circuits/:
  glmul_chain.circom    GLMulChain(N): N chained Goldilocks products
                        emulated over BN254's Fr, each result and quotient
                        range checked by an inline 64-bit decomposition
                        (the shape of gl.circom's GLMul, which the final
                        SNARK circuit is made of); x public, y private.
  glsquare_chain.circom GLSquareChain(N): N chained squarings plus 7 over
                        the Goldilocks field itself, each value range
                        checked the same way; x public.

Two routes, each stage timed (EIGEN_ZKVM_SYNC=1, set by main, drains the
device at every Prof tick):
  groth16     (`groth16_route`) compile over BN254's Fr, simplify at -O2,
              write the .r1cs, .wtns and .sym files (cli.compile_files,
              the CLI's `compile`), then Groth16 setup (draws
              from bench_groth16.seeded(G16_SEED)), prove (seeded(G16_SEED
              + 1)) and verify on the device, and the verify of a changed
              public, which must fail;
  compressor  (`compressor_route`) compile over Goldilocks, pack the R1CS
              into the 12-column compressor PIL (recursion/plonk_setup.py
              PlonkSetup, exec_witness), write its PIL, struct
              (recursion/compressor12.default_compressor_struct), constant
              and committed files, and prove them through the port's
              file-based stark_prove on the device, which verifies its
              proof and writes the verifier's circom text; the skip_main
              variant of that text is rendered from the same setup.
Each route records its stages' seconds, the kernels' launches (counts set
to 0 at the route's start, read before and after each step), peak device
memory and the
sha256 of every file and proof it makes.  `render` gives the verifier's
circom text of a setup; chip_smoke.py renders the recursion chain's
layers with it, kept by `layer_keeper`, with `LAYER_OPTIONS`.  The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import tempfile
import time
from types import SimpleNamespace

CIRCUITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "circuits")
GLMUL = os.path.join(CIRCUITS, "glmul_chain.circom")
GLSQUARE = os.path.join(CIRCUITS, "glsquare_chain.circom")
# the committed sizes: GLMul 131,001 constraints (129,000 after -O2, domain
# 2^17); GLSquare 72,666 constraints, a 2^16-row compressor trace
GLMUL_N, GLSQUARE_N = 1000, 1100
GLMUL_INPUTS = {"x": 3, "y": 0x123456789ABCDEF}
GLSQUARE_INPUTS = {"x": 3}
GL_PRIME = 0xFFFFFFFF00000001
# Groth16's draws: setup from bench_groth16.seeded(G16_SEED), the prove
# from seeded(G16_SEED + 1)
G16_SEED = 1
# The options each recursion layer's verifier is rendered with: those the
# next layer's compressor12 setup gets (bench_recursion.run_layers,
# bench_e2e.final_layer); the final BN128 layer's are build_final_main's.
LAYER_OPTIONS = {
    "c12": {},
    "recursive1": {"verkey_input": True, "agg_stage": True},
    "aggregation": {"verkey_input": True},
    "final": {},
}
# the layers of the recursion chain whose verifiers chip_smoke.py renders
RENDERED_LAYERS = ("c12 0", "recursive1 0", "aggregation", "final")
# the kernels the two routes run
SOURCES = ("msm.cu", "msm_g2.cu", "msm_g2_sums.cu", "ec_batch.cu",
           "fr_ntt.cu", "r1cs.cu", "ntt.cu", "poseidon_gl.cu")


def source(path: str, n: int | None = None) -> str:
    """A circuit's text, its main component's template argument set to n."""
    with open(path) as f:
        text = f.read()
    if n is None:
        return text
    text, k = re.subn(r"(component main\b[^=]*=\s*\w+\()\d+(\))",
                      rf"\g<1>{n}\g<2>", text)
    if k != 1:
        raise ValueError(f"{path}: no `component main = T(N)` line")
    return text


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def render(pil, setup, ss, options: dict) -> str:
    """The verifier's circom text of a proof under (pil, setup, ss), setup
    a StarkSetup (its const root, starkinfo and program), with
    pil2circom's StarkOption(**options)."""
    from .stark.pil2circom import StarkOption, pil2circom

    return pil2circom(pil, setup.const_root, ss, setup.starkinfo,
                      setup.program, StarkOption(**options))


def layer_keeper(store: dict):
    """An `on_layer` callback for bench_recursion.run_layers and
    bench_e2e.run_final_and_wrap: keeps in `store`, for the layers of
    RENDERED_LAYERS, what `render` needs of a layer (its PIL, struct,
    const root, starkinfo and program: host objects, not the device tree)
    as (pil, setup, struct)."""
    def keep(label, bundle):
        if label in RENDERED_LAYERS:
            st, ss, ps = bundle
            store[label] = (ps.pil, SimpleNamespace(
                const_root=st.const_root, starkinfo=st.starkinfo,
                program=st.program), ss)
    return keep


def _device(device):
    import torch

    from .groth16 import groth16 as g16

    dev = g16.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def _peak(dev):
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def groth16_route(text: str, inputs: dict, device=None):
    """The groth16 route of one circuit source (module docstring) on
    `device` (None: the current CUDA device, raising without one; "cpu"
    runs the kernels' plain versions).  (record, builder, proving key)"""
    from . import bench_groth16, kernels
    from .cli import compile_files
    from .curves import bn254
    from .groth16 import api
    from .groth16 import groth16 as g16
    from .utils.profiler import Prof

    dev = _device(device)
    kernels.reset_counts()
    prof = Prof("circom.groth16", dev, on=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "circuit")
        b, stats = compile_files(text, inputs, bn254.R, base, prof=prof)
        digests = {ext: sha256(_read(base + ext))
                   for ext in (".r1cs", ".wtns", ".sym")}
    counts = [kernels.counts()]
    pk, vk = g16.setup(b.constraints, b.n_vars, b.n_publics,
                       rng=bench_groth16.seeded(G16_SEED), device=dev,
                       prof=prof)
    counts.append(kernels.counts())
    proof, publics = g16.prove(pk, b.constraints, b.w,
                               rng=bench_groth16.seeded(G16_SEED + 1),
                               prof=prof)
    counts.append(kernels.counts())
    ok = g16.verify(vk, proof, publics)
    prof.tick("verify")
    bad = list(publics)
    bad[0] = (bad[0] + 1) % bn254.R
    rejected = not g16.verify(vk, proof, bad)
    prof.tick("verify (changed public)")
    proof_json = api.proof_to_json(proof, "bn128")
    digests["proof"] = sha256(proof_json.encode())
    rec = dict(route="groth16", wall_s=time.perf_counter() - t0,
               stages=prof.stages, constraints=len(b.constraints),
               wires=b.n_vars, publics=b.n_publics, simplify=stats,
               domain=pk.domain_size, verified=ok,
               tampered_rejected=rejected, public_values=publics,
               launches={step: {k: after[k] - before[k] for k in after}
                         for step, before, after in (
                             ("setup", *counts[:2]),
                             ("prove", *counts[1:]))},
               peak_bytes=_peak(dev), digests=digests)
    return rec, b, pk


def struct_json(ss) -> dict:
    return {"nBits": ss.nBits, "nBitsExt": ss.nBitsExt,
            "nQueries": ss.nQueries,
            "verificationHashType": ss.verificationHashType,
            "steps": [{"nBits": s.nBits} for s in ss.steps]}


def compressor_route(text: str, inputs: dict, device=None,
                     out_dir: str | None = None):
    """The compressor route of one circuit source (module docstring) on
    `device` (None: the current CUDA device, raising without one; "cpu"
    runs the kernels' plain versions).  (record, {"default", "skip_main":
    circom text})"""
    from . import kernels
    from .bench_chain import pil_to_json
    from .dsl.elaborate import compile_circom
    from .recursion.compressor12 import default_compressor_struct
    from .recursion.plonk_setup import PlonkSetup, exec_witness
    from .stark.prove import stark_prove
    from .utils.profiler import Prof

    dev = _device(device)
    kernels.reset_counts()
    prof = Prof("circom.compressor", dev, on=True)
    t0 = time.perf_counter()
    b = compile_circom(text, inputs, prime=GL_PRIME)
    prof.tick("compile")
    psetup = PlonkSetup(b)
    prof.tick("PlonkSetup")
    cm = exec_witness(b, psetup)
    prof.tick("exec_witness")
    ss = default_compressor_struct(psetup.n_bits)
    with tempfile.TemporaryDirectory() as tmp:
        d = out_dir or tmp
        files = {k: os.path.join(d, f"c12.{k}") for k in (
            "pil", "struct", "const", "cm", "zkin", "circom")}
        with open(files["pil"], "w") as f:
            json.dump(pil_to_json(psetup.pil), f)
        with open(files["struct"], "w") as f:
            json.dump(struct_json(ss), f)
        psetup.const_pols.save(files["const"])
        cm.save(files["cm"])
        prof.tick("write")
        before = kernels.counts()
        _, setup = stark_prove(files["struct"], files["pil"], files["const"],
                               files["cm"], zkin_out=files["zkin"],
                               circom_out=files["circom"], device=dev,
                               prof=prof)
        after = kernels.counts()
        prof.tick("verify, write zkin and circom")
        texts = {"default": _read(files["circom"]).decode(),
                 "skip_main": render(psetup.pil, setup, ss,
                                     {"verkey_input": True,
                                      "skip_main": True})}
        prof.tick("render skip_main")
        digests = {"zkin": sha256(_read(files["zkin"]))}
        digests.update({f"circom {k}": sha256(v.encode())
                        for k, v in texts.items()})
    rec = dict(route="compressor", wall_s=time.perf_counter() - t0,
               stages=prof.stages, constraints=len(b.constraints),
               publics=b.n_publics, n_bits=psetup.n_bits,
               n_used=psetup.n_used, n_const=psetup.pil.nConstants,
               steps=[s.nBits for s in ss.steps], queries=ss.nQueries,
               launches={k: after[k] - before[k] for k in after},
               peak_bytes=_peak(dev), digests=digests)
    return rec, texts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="the chain's length (default: the committed "
                         f"sizes, {GLMUL_N} and {GLSQUARE_N})")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions (default: "
                         "the current CUDA device)")
    args = ap.parse_args(argv)
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")

    from . import kernels
    from .utils.devices import card_line

    res = {"routes": {}}
    if args.device != "cpu":
        res["card"] = card_line()
        print(f"card: {res['card']}", flush=True)
        res["build_s"] = kernels.load(SOURCES)["seconds"]
    res["routes"]["groth16"], _, _ = groth16_route(
        source(GLMUL, args.n or GLMUL_N), GLMUL_INPUTS, args.device)
    res["routes"]["compressor"], _ = compressor_route(
        source(GLSQUARE, args.n or GLSQUARE_N), GLSQUARE_INPUTS, args.device)
    for name, rec in res["routes"].items():
        print(f"{name}: {rec['wall_s']:.3f} s: "
              + ", ".join(f"{st} {t:.3f}" for st, t in rec["stages"])
              + f"; launches {rec['launches']}; digests {rec['digests']}",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
