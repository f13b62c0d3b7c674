"""The circom surface of the port on the card (marked cuda; skipped without
one), and the JAX host engine's digests that chip_smoke.py's phase 12
holds it to (marked slow).  The card test imports nothing of JAX: run it
on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_circom_cuda.py

bench_circom's two routes at the committed sizes: GLMulChain(1000)
compiled over BN254's Fr at -O2, its files written and a Groth16 setup
(draws from bench_groth16.seeded(bench_circom.G16_SEED)), prove
(seeded(G16_SEED + 1)) and verify on the card; GLSquareChain(1100)
compiled over Goldilocks, packed into the compressor PIL (2^16 rows) and
proved through the file-based stark_prove on the card, with both renders
of its verifier.  The files, the proof JSON, the zkin and the renders
must equal chip_smoke.CIRCOM_SHA256, which
`test_host_engine_gives_the_pinned_circuit_digests` recomputes with the
JAX package on the CPU, and
`test_host_engine_gives_the_pinned_layer_renders` the renders of the
recursion chain's layers (chip_smoke.py's phases 10 and 11).
"""
import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIRCUIT_KEYS = ("glmul .r1cs", "glmul .wtns", "glmul .sym", "glmul proof",
                "glsquare zkin", "glsquare circom default",
                "glsquare circom skip_main")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_digests(groth16: dict, compressor: dict) -> dict:
    """bench_circom's two records' digests under chip_smoke's keys."""
    out = {f"glmul {k}": v for k, v in groth16.items()}
    out.update({f"glsquare {k}": v for k, v in compressor.items()})
    return out


@pytest.mark.cuda
def test_circom_routes_on_the_card_give_the_pinned_digests():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eigen_zkvm_tpu_torch import bench_circom as bc
    from eigen_zkvm_tpu_torch import kernels

    g, _, _ = bc.groth16_route(bc.source(bc.GLMUL, bc.GLMUL_N),
                               bc.GLMUL_INPUTS)
    c, _ = bc.compressor_route(bc.source(bc.GLSQUARE, bc.GLSQUARE_N),
                               bc.GLSQUARE_INPUTS)
    print(g, c)
    assert g["verified"] and g["tampered_rejected"]
    assert g["launches"]["setup"][kernels.EC_BATCH.name] > 0
    assert all(g["launches"]["prove"][k.name] > 0 for k in (
        kernels.MSM, kernels.FR_NTT, kernels.R1CS))
    assert c["n_bits"] == 16
    assert all(c["launches"][k.name] > 0
               for k in (kernels.NTT, kernels.POSEIDON))
    want = _smoke().CIRCOM_SHA256
    assert route_digests(g["digests"], c["digests"]) == \
        {k: want[k] for k in CIRCUIT_KEYS}


def host_glmul_digests(n: int, tmp_path) -> dict:
    """bench_circom's groth16 route through the JAX package on the CPU (its
    host engine): the same circuit, inputs and draws; the digests under
    chip_smoke's keys."""
    import hashlib

    from eigen_zkvm_tpu.algebraic import r1cs_file as j_r1cs
    from eigen_zkvm_tpu.algebraic import witness as j_wit
    from eigen_zkvm_tpu.curves import bn254 as j_bn
    from eigen_zkvm_tpu.dsl.elaborate import compile_circom, write_sym
    from eigen_zkvm_tpu.dsl.simplify import simplify
    from eigen_zkvm_tpu.groth16 import api as j_api
    from eigen_zkvm_tpu.groth16 import groth16 as j_g16
    from eigen_zkvm_tpu_torch import bench_circom as bc
    from eigen_zkvm_tpu_torch import bench_groth16

    def sha(data):
        return hashlib.sha256(data).hexdigest()

    b = compile_circom(bc.source(bc.GLMUL, n), bc.GLMUL_INPUTS, prime=j_bn.R)
    simplify(b, level=2)
    sym = str(tmp_path / "glmul.sym")
    write_sym(b, sym)
    pk, vk = j_g16.setup(j_bn, b.constraints, b.n_vars, b.n_publics,
                         rng=bench_groth16.seeded(bc.G16_SEED))
    proof, pubs = j_g16.prove(j_bn, pk, b.constraints, b.w,
                              rng=bench_groth16.seeded(bc.G16_SEED + 1))
    assert j_g16.verify(j_bn, vk, proof, pubs)
    with open(sym, "rb") as f:
        return {"glmul .r1cs": sha(j_r1cs.to_bytes(j_r1cs.circuit_to_r1cs(b))),
                "glmul .wtns": sha(j_wit.witness_to_bytes(b.w, b.P)),
                "glmul .sym": sha(f.read()),
                "glmul proof": sha(j_api.proof_to_json(proof,
                                                       "bn128").encode())}


def host_glsquare_digests(n: int, out_dir) -> dict:
    """bench_circom's compressor route through the JAX package on the CPU
    (its host engine): the same circuit and inputs, its files written to
    `out_dir` as the route writes them, proved by the JAX package's
    file-based stark_prove; the digests under chip_smoke's keys."""
    import hashlib
    import json

    from eigen_zkvm_tpu.dsl.elaborate import compile_circom
    from eigen_zkvm_tpu.recursion import compressor12 as j_c12
    from eigen_zkvm_tpu.recursion import plonk_setup as j_plonk
    from eigen_zkvm_tpu.stark import pil2circom as j_p2c
    from eigen_zkvm_tpu.stark.prove import stark_prove
    from eigen_zkvm_tpu_torch import bench_circom as bc
    from eigen_zkvm_tpu_torch.bench_chain import pil_to_json

    b = compile_circom(bc.source(bc.GLSQUARE, n), bc.GLSQUARE_INPUTS,
                       prime=bc.GL_PRIME)
    ps = j_plonk.PlonkSetup(b)
    cm = j_plonk.exec_witness(b, ps)
    ss = j_c12.default_compressor_struct(ps.n_bits)
    files = {k: os.path.join(str(out_dir), f"c12.{k}") for k in (
        "pil", "struct", "const", "cm", "zkin", "circom")}
    with open(files["pil"], "w") as f:
        json.dump(pil_to_json(ps.pil), f)
    with open(files["struct"], "w") as f:
        json.dump(bc.struct_json(ss), f)
    ps.const_pols.save(files["const"])
    cm.save(files["cm"])
    _, setup = stark_prove(files["struct"], files["pil"], files["const"],
                           files["cm"], zkin_out=files["zkin"],
                           circom_out=files["circom"])
    skip = j_p2c.pil2circom(ps.pil, setup.const_root, ss, setup.starkinfo,
                            setup.program,
                            j_p2c.StarkOption(verkey_input=True,
                                              skip_main=True))
    out = {}
    for key, name in (("glsquare zkin", "zkin"),
                      ("glsquare circom default", "circom")):
        with open(files[name], "rb") as f:
            out[key] = hashlib.sha256(f.read()).hexdigest()
    out["glsquare circom skip_main"] = hashlib.sha256(
        skip.encode()).hexdigest()
    return out


@pytest.mark.slow
def test_host_engine_gives_the_pinned_circuit_digests(monkeypatch, tmp_path):
    """chip_smoke.CIRCOM_SHA256's circuit keys: the JAX package's compiler,
    simplify, file writers, Groth16 (its host engine) and file-based
    stark_prove over the committed sizes; printed.  A few minutes on the
    CPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    from eigen_zkvm_tpu_torch import bench_circom as bc

    got = host_glmul_digests(bc.GLMUL_N, tmp_path)
    got.update(host_glsquare_digests(bc.GLSQUARE_N, tmp_path))
    print(got)
    want = _smoke().CIRCOM_SHA256
    assert got == {k: want[k] for k in CIRCUIT_KEYS}


@pytest.mark.slow
def test_host_engine_gives_the_pinned_layer_renders(monkeypatch):
    """chip_smoke.CIRCOM_SHA256's layer keys: the JAX package's host
    engine proves the ecrecover guest's chunks 0 and 1, c12, recursive1 at
    2^18 and the chained aggregation (as tests/test_torch_wrap_cuda.py's
    pinned test), then sets up the final BN128 layer; each layer's
    verifier of chunk 0's branch and of the aggregation and final layer is
    rendered with bench_circom.LAYER_OPTIONS; printed.  About fifteen
    minutes and 25 GB on the CPU."""
    import hashlib

    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    from eigen_zkvm_tpu.recursion import aggregation as j_agg
    from eigen_zkvm_tpu.recursion import compressor12 as j_c12
    from eigen_zkvm_tpu.stark import pil2circom as j_p2c
    from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu.stark.stark_setup import StarkSetup
    from eigen_zkvm_tpu.stark.types import StarkStruct, Step
    from eigen_zkvm_tpu.zkvm import elf as j_elf
    from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
    from eigen_zkvm_tpu.zkvm import rv32_native as j_native
    from eigen_zkvm_tpu.zkvm.lib import default_struct
    from eigen_zkvm_tpu_torch import bench_circom as bc
    from eigen_zkvm_tpu_torch import bench_e2e, bench_zkvm

    def render(label, bundle):
        st, ss, ps = bundle
        text = j_p2c.pil2circom(ps.pil, st.const_root, ss, st.starkinfo,
                                st.program, j_p2c.StarkOption(
                                    **bc.LAYER_OPTIONS[label.split()[0]]))
        out[label] = hashlib.sha256(text.encode()).hexdigest()
        print(label, out[label], len(text), flush=True)

    smoke = _smoke()
    q, force = smoke.RECURSION_QUERIES, smoke.RECURSION_FORCE
    program, entry, image0, ram_words, mem_base = j_elf.load_elf(
        bench_zkvm.read_guest(), include_exec_in_image=False)
    nc = j_native.NativeChunker(program, entry, n_bits=bench_zkvm.NBITS,
                                ram_words=ram_words, image0=image0,
                                mem_base=mem_base)
    m = j_rv32.Rv32Machine(program, bench_zkvm.NBITS, ram_words=ram_words,
                           mem_base=mem_base)
    ss = default_struct(bench_zkvm.NBITS, q)
    setup = StarkSetup(m.const_pols, m.pil, ss)
    out, r1 = {}, []
    for k in smoke.ZKVM_CHUNKS:
        states, image_in = nc.states_for(k)
        z = stark_proof_to_dict(stark_gen(
            m.trace(states, image_in=image_in), m.const_pols,
            setup.const_tree, setup.starkinfo, setup.program, ss), "GL")
        del states
        proof, c12 = j_c12.prove_compressed(
            z, setup, ss, j_c12.StarkOption(skip_main=True), n_queries=q)
        if k == smoke.ZKVM_CHUNKS[0]:
            render(f"c12 {k}", c12)
        proof, r1_bundle = j_c12.prove_compressed(
            stark_proof_to_dict(proof, "GL"), c12[0], c12[1],
            j_c12.StarkOption(), n_queries=q, force_n_bits=force)
        if k == smoke.ZKVM_CHUNKS[0]:
            render(f"recursive1 {k}", r1_bundle)
        r1.append(stark_proof_to_dict(proof, "GL"))
        del c12
    del setup, nc
    final, agg = j_agg.aggregate_recursive1(
        r1, r1_bundle[0], r1_bundle[1], force_n_bits=force, n_queries=q,
        chain_map=j_c12.ChainMap.for_machine(m))
    render("aggregation", agg)
    _, ps4 = j_c12.compressor12_setup(final, agg[0], agg[1],
                                      j_c12.StarkOption(verkey_input=True))
    ss4 = StarkStruct.from_json(bc.struct_json(
        bench_e2e.final_struct(ps4.n_bits, q)))
    render("final", (StarkSetup(ps4.const_pols, ps4.pil, ss4), ss4, ps4))
    print(out)
    assert out == {k: v for k, v in smoke.CIRCOM_SHA256.items()
                   if k not in CIRCUIT_KEYS}
