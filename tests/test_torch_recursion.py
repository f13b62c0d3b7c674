"""The port's GL recursion layers (eigen_zkvm_tpu_torch/recursion/) on the
CPU, against the JAX package's (eigen_zkvm_tpu/recursion/), tolerance 0:
every value is a field element.

The builder's gadgets give the JAX builder's witness, constraints and gate
lists on the same seeded inputs.  On the fibonacci AIR at 2^10 rows and 2
queries (examples/fibonacci.py, both packages' copies): the compressor's
PIL JSON, constants, s_map, plonk additions and .exec bytes, the witness
pass's committed columns, the CLI's compressor12_setup / compressor12_exec
files (from a zkin and from a .r1cs), and the c12 proof (2^13 rows) are
the JAX package's, byte for byte; a tampered witness fails check().
recursive1 is in test_torch_recursion_r1.py, the chained MEMWALK
aggregation in test_torch_recursion_agg.py, the layers on the card in
test_torch_recursion_cuda.py.  The JAX package proves on its host engine
(EIGEN_ZKVM_ENGINE=host); the port on Engine("cpu"), one torch thread.
"""
import json
import os

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu import cli as j_cli
from eigen_zkvm_tpu.algebraic import r1cs_file as j_r1cs
from eigen_zkvm_tpu.examples import fibonacci as j_fib
from eigen_zkvm_tpu.fields import f3g
from eigen_zkvm_tpu.recursion import circuit as j_circuit
from eigen_zkvm_tpu.recursion import compressor12 as j_c12
from eigen_zkvm_tpu.recursion import gadgets as j_gadgets
from eigen_zkvm_tpu.recursion import plonk_setup as j_plonk
from eigen_zkvm_tpu.stark import stark_gen as j_gen
from eigen_zkvm_tpu.stark import stark_setup as j_setup
from eigen_zkvm_tpu.stark import types as j_types
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict as j_dict
from eigen_zkvm_tpu_torch import cli, convert
from eigen_zkvm_tpu_torch.algebraic import r1cs_file
from eigen_zkvm_tpu_torch.bench_chain import pil_to_json
from eigen_zkvm_tpu_torch.examples import fibonacci
from eigen_zkvm_tpu_torch.recursion import (aggregation, circuit,
                                            compressor12, gadgets,
                                            plonk_setup)
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_dict
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.types import StarkStruct, Step

FIB_NBITS, FIB_QUERIES = 10, 2
P = circuit.P
CPU = Engine("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain Poseidon and the eager field code are many small tensor
    operations: one torch thread each, so as not to contend with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _host_engine():
    """The JAX package's host engine: it never probes for a TPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EIGEN_ZKVM_ENGINE", "host")
        yield


def fib_struct(types):
    """The fibonacci proof's struct, in the JAX package's or the port's
    types: 2^10 -> 2^11 rows, FIB_QUERIES queries, FRI steps 11 and 5."""
    return types.StarkStruct(nBits=FIB_NBITS, nBitsExt=FIB_NBITS + 1,
                             nQueries=FIB_QUERIES, verificationHashType="GL",
                             steps=[types.Step(FIB_NBITS + 1), types.Step(5)])


class Fib:
    """The fibonacci proof of both packages and their setups."""

    def __init__(self, inputs=(1, 2)):
        pil, cp, mk = j_fib.build(FIB_NBITS)
        self.j_ss = fib_struct(j_types)
        self.j_setup = j_setup.StarkSetup(cp, pil, self.j_ss)
        self.j_zkin = j_dict(j_gen.stark_gen(
            mk(inputs), cp, self.j_setup.const_tree, self.j_setup.starkinfo,
            self.j_setup.program, self.j_ss), "GL")
        pil, cp, mk = fibonacci.build(FIB_NBITS)
        self.pil, self.const_pols, self.cm_pols = pil, cp, mk(inputs)
        self.ss = StarkStruct(nBits=FIB_NBITS, nBitsExt=FIB_NBITS + 1,
                              nQueries=FIB_QUERIES, verificationHashType="GL",
                              steps=[Step(FIB_NBITS + 1), Step(5)])
        self.setup = StarkSetup(cp, pil, self.ss, CPU)
        self.zkin = stark_proof_to_dict(stark_gen(
            self.cm_pols, cp, self.setup.const_tree, self.setup.starkinfo,
            self.setup.program, self.ss, engine=CPU), "GL")


@pytest.fixture(scope="module")
def fib():
    return Fib()


@pytest.fixture(scope="module")
def c12_setups(fib):
    """compressor12_setup (skip_main) of the fibonacci zkin in both
    packages: (port circuit, port PlonkSetup, JAX circuit, JAX PlonkSetup)."""
    c, ps = compressor12.compressor12_setup(
        fib.zkin, fib.setup, fib.ss, compressor12.StarkOption(skip_main=True))
    jc, jps = j_c12.compressor12_setup(
        fib.j_zkin, fib.j_setup, fib.j_ss,
        j_c12.StarkOption(skip_main=True))
    return c, ps, jc, jps


# ---- the builder's gadgets


def _rand(rng, n):
    return [int(x) for x in rng.integers(0, P, n, dtype=np.uint64)]


def _gadget(mod, gmod, name: str, seed: int):
    """One gadget on `mod`'s builder over seeded inputs."""
    rng = np.random.default_rng(seed)
    b = mod.CircuitBuilder()
    W = mod.W

    def sigs(n):
        return [b.sig(v) for v in _rand(rng, n)]

    def f3():
        return tuple(b.wire(s) for s in sigs(3))

    if name == "mul_inv":
        x, y = (b.wire(s) for s in sigs(2))
        z = b.mul(x + y, y - W(k=3))
        b.assert_eq(b.mul(b.inv(z), z), W(k=1))
    elif name == "bits":
        b.bits(b.wire(b.sig(0xDEADBEEF12345678)), 64)
        b.bits(b.wire(b.sig(P - 1)), 64)
        b.bits(b.wire(b.sig(12345)), 20, strict=False)
    elif name == "mux_materialize":
        bit = b.bits(b.wire(b.sig(5)), 3)[0]
        x, y = f3()[:2]
        b.materialize(b.mux(bit, x, y).scale(7) + W(k=9))
    elif name == "f3_mul":
        a, c = f3(), f3()
        b.f3_mul(a, c, f3())                          # CMulAdd gate
        b.f3_mul((a[0], W(), W()), c)                 # Karatsuba
    elif name == "f3_inv":
        b.f3_inv(f3())
    elif name == "ev_pol4":
        b.ev_pol4([f3() for _ in range(4)], f3(), f3())
    elif name == "eval_pol":
        gmod.eval_pol(b, [f3() for _ in range(11)], f3())
    elif name == "group_intt":
        for n in (4, 8, 16, 32):
            gmod.group_intt(b, [f3() for _ in range(n)])
    elif name == "poseidon":
        b.poseidon(sigs(12))
    elif name == "linear_hash":
        gmod.linear_hash(b, sigs(3))
        gmod.linear_hash(b, sigs(31))
    elif name == "transcript":
        t = gmod.CircuitTranscript(b)
        t.put_many(sigs(9))
        t.get_field()
        t.get_permutations(2, 11)
    else:
        raise ValueError(name)
    return b


GADGETS = ["mul_inv", "bits", "mux_materialize", "f3_mul", "f3_inv",
           "ev_pol4", "eval_pol", "group_intt", "poseidon", "linear_hash",
           "transcript"]


@pytest.mark.parametrize("name", GADGETS)
def test_gadget_gives_the_jax_builders_witness_and_constraints(name):
    b = _gadget(circuit, gadgets, name, 7)
    jb = _gadget(j_circuit, j_gadgets, name, 7)
    assert b.w == jb.w
    assert b.constraints == jb.constraints
    assert b.custom_gates == jb.custom_gates
    assert b.check() and jb.check()


def test_f3_values_match_the_jax_field():
    rng = np.random.default_rng(11)
    b = circuit.CircuitBuilder()
    av, bv = (rng.integers(0, P, 3, dtype=np.uint64) for _ in range(2))
    a = tuple(b.wire(b.sig(int(x))) for x in av)
    c = tuple(b.wire(b.sig(int(x))) for x in bv)
    assert list(b.f3_val(b.f3_mul(a, c))) == [int(x) for x in f3g.mul(av, bv)]
    assert list(b.f3_val(b.f3_inv(a))) == [int(x) for x in f3g.inv(av)]
    assert b.check()


def test_poseidon_gadget_is_the_port_hash():
    from eigen_zkvm_tpu_torch.ops import gl, poseidon

    vals = _rand(np.random.default_rng(3), 12)
    b = circuit.CircuitBuilder()
    out = b.poseidon([b.sig(v) for v in vals])
    want = gl.to_u64(poseidon.permute(gl.from_u64(
        np.array([vals], dtype=np.uint64))))[0]
    assert [b.w[s] for s in out] == [int(x) for x in want]


@pytest.mark.parametrize("gate", ["Poseidon12", "CMulAdd", "EvPol4", "FFT4",
                                  "r1cs"])
def test_check_rejects_a_wrong_gate_output(gate):
    """check() holds every gate kind: one output value off fails it."""
    b = circuit.CircuitBuilder()
    if gate == "r1cs":
        x = b.wire(b.sig(3))
        s = next(iter(b.mul(x, x).lc))
    else:
        name = {"Poseidon12": "poseidon", "CMulAdd": "f3_mul",
                "EvPol4": "ev_pol4", "FFT4": "group_intt"}[gate]
        b = _gadget(circuit, gadgets, name, 5)
        entry = next(e for e in b.custom_gates if e[0] == gate)
        s = entry[1][-1]
    assert b.check()
    b.w[s] = (b.w[s] + 1) % P
    assert not b.check()


# ---- compressor12 on the fibonacci proof


def test_fibonacci_proofs_are_the_jax_packages(fib):
    assert fib.zkin == fib.j_zkin
    assert pil_to_json(fib.pil) == j_cli._pil_to_json(
        j_fib.build(FIB_NBITS)[0])


def test_compressor12_setup_matches_field_by_field(c12_setups):
    c, ps, jc, jps = c12_setups
    want = convert.plonk_setup_from_jax(jps)
    assert (ps.n_bits, ps.n_used, ps.n_publics) == (13, want.n_used, 1)
    assert json.dumps(pil_to_json(ps.pil)) == json.dumps(
        j_cli._pil_to_json(jps.pil))
    assert ps.pil.nConstants == 31 and ps.pil.nCommitments == 12
    assert np.array_equal(ps.const_pols.buffer, want.const_pols.buffer)
    assert np.array_equal(ps.s_map, want.s_map)
    assert [(a.s1, a.s2, a.c1, a.c2) for a in ps.plonk_additions] == \
        [(a.s1, a.s2, a.c1, a.c2) for a in want.plonk_additions]
    assert c.n_publics == jc.n_publics and c.w == jc.w
    assert c.constraints == jc.constraints
    assert c.custom_gates == jc.custom_gates


def test_exec_file_bytes_and_witness_match(tmp_path, fib, c12_setups):
    c, ps, jc, jps = c12_setups
    path, j_path = str(tmp_path / "port.exec"), str(tmp_path / "jax.exec")
    compressor12.write_exec_file(path, ps)
    j_c12.write_exec_file(j_path, jps)
    with open(path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    adds, s_map = compressor12.read_exec_file(path)
    assert adds.shape == (len(ps.plonk_additions), 4)
    assert np.array_equal(s_map, ps.s_map)

    cm = plonk_setup.exec_witness(c, ps)
    assert np.array_equal(cm.buffer, j_plonk.exec_witness(jc, jps).buffer)
    # the witness pass alone (record=False), on a setup read back from the
    # .exec and the PIL, scatters the same columns
    again = compressor12.compressor12_exec(
        fib.zkin, fib.setup, fib.ss, compressor12.StarkOption(skip_main=True),
        plonk_setup.PlonkSetup.from_exec(ps.pil, adds, s_map))
    assert np.array_equal(again.buffer, cm.buffer)


def test_tampered_witness_fails_check(c12_setups):
    c, _, _, _ = c12_setups
    assert c.check()
    bad = circuit.CircuitBuilder()
    bad.w = list(c.w)
    bad.w[1] = (bad.w[1] + 1) % P
    bad.constraints = c.constraints
    bad.custom_gates = c.custom_gates
    assert not bad.check()


def _files(tmp_path, fib):
    """The fibonacci proof's inner PIL, struct, constants and zkin files."""
    f = {k: str(tmp_path / k) for k in ("pil.json", "ss.json", "const",
                                        "zkin.json")}
    with open(f["pil.json"], "w") as fh:
        json.dump(pil_to_json(fib.pil), fh)
    with open(f["ss.json"], "w") as fh:
        json.dump({"nBits": FIB_NBITS, "nBitsExt": FIB_NBITS + 1,
                   "nQueries": FIB_QUERIES, "verificationHashType": "GL",
                   "steps": [{"nBits": FIB_NBITS + 1}, {"nBits": 5}]}, fh)
    fib.const_pols.save(f["const"])
    with open(f["zkin.json"], "w") as fh:
        json.dump(fib.zkin, fh)
    return f


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_cli_compressor12_files_match_the_jax_cli(tmp_path, fib):
    """compressor12_setup and compressor12_exec through both CLIs: the
    .pil.json, .const, .exec and .cm bytes are the JAX CLI's."""
    f = _files(tmp_path, fib)
    out = {}
    for pkg in ("port", "jax"):
        o = {k: str(tmp_path / f"{pkg}.{k}") for k in ("pil", "const", "exec",
                                                       "cm")}
        setup = ["compressor12_setup", "-i", f["zkin.json"], "--inner_pil",
                 f["pil.json"], "--inner_struct", f["ss.json"],
                 "--inner_const", f["const"], "-p", o["pil"], "-c",
                 o["const"], "-e", o["exec"], "--skip_main"]
        run = ["compressor12_exec", "-i", f["zkin.json"], "-p", o["pil"],
               "-e", o["exec"], "-m", o["cm"]]
        if pkg == "port":
            assert cli.main(setup + ["--device", "cpu"]) == 0
            assert cli.main(run) == 0
        else:
            j_cli.main(setup)
            j_cli.main(run)
        out[pkg] = {k: _read(v) for k, v in o.items()}
    for k in ("pil", "const", "exec", "cm"):
        assert out["port"][k] == out["jax"][k], k


def test_cli_compressor12_setup_from_r1cs_matches_the_jax_cli(
        tmp_path, c12_setups):
    """The interop path: the verifier circuit as a circom .r1cs with custom
    gates (the same bytes from either package's circuit_to_r1cs), then
    compressor12_setup --r1cs through both CLIs."""
    c, ps, jc, _ = c12_setups
    path = str(tmp_path / "c12.r1cs")
    r1cs_file.save_r1cs(path, r1cs_file.circuit_to_r1cs(c))
    assert _read(path) == j_r1cs.to_bytes(j_r1cs.circuit_to_r1cs(jc))
    out = {}
    for pkg, main in (("port", cli.main), ("jax", j_cli.main)):
        o = {k: str(tmp_path / f"{pkg}.{k}") for k in ("pil", "const",
                                                       "exec")}
        main(["compressor12_setup", "-r", path, "-p", o["pil"], "-c",
              o["const"], "-e", o["exec"]])
        out[pkg] = {k: _read(v) for k, v in o.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["exec"] == _read_exec_of(tmp_path, ps)


def _read_exec_of(tmp_path, ps):
    path = str(tmp_path / "direct.exec")
    compressor12.write_exec_file(path, ps)
    return _read(path)


def test_c12_proof_is_the_jax_packages(fib):
    """The c12 layer (skip_main, 2^13 rows, 31 constant columns) proved by
    the port on the CPU: the proof JSON is the JAX host engine's."""
    proof, (st, ss, ps) = compressor12.prove_compressed(
        fib.zkin, fib.setup, fib.ss, compressor12.StarkOption(skip_main=True),
        n_queries=FIB_QUERIES, engine=CPU)
    j_proof, _ = j_c12.prove_compressed(
        fib.j_zkin, fib.j_setup, fib.j_ss,
        j_c12.StarkOption(skip_main=True), n_queries=FIB_QUERIES)
    assert (ps.n_bits, ss.nBits, len(ss.steps)) == (13, 13, 4)
    assert stark_proof_to_dict(proof, "GL") == j_dict(j_proof, "GL")
    assert int(proof.publics[0, 0]) == int(fib.zkin["publics"][0])


def test_entry_points_raise_without_a_card(fib, monkeypatch):
    """prove_compressed and aggregate_recursive1 take the current CUDA
    device unless given an engine: without one they raise before any
    work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = compressor12.StarkOption(skip_main=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compressor12.prove_compressed(fib.zkin, fib.setup, fib.ss, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregation.aggregate_recursive1([fib.zkin, fib.zkin], fib.setup,
                                         fib.ss, force_n_bits=14)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["compressor12_setup", "-i", "z", "--inner_pil", "p",
                  "--inner_struct", "s", "--inner_const", "c", "-p", "o",
                  "-c", "o", "-e", "o"])


def test_default_compressor_struct_matches(fib):
    for nb in (11, 13, 14, 18):
        got = compressor12.default_compressor_struct(nb, 4)
        want = j_c12.default_compressor_struct(nb, 4)
        assert convert.struct_from_jax(want) == got


def _host_chain(zkins, setup, ss, queries: int, force: int,
                chain_map=None) -> dict:
    """bench_recursion.run_layers on the JAX package's host engine: the
    sha256 of each layer's zkin JSON, by the same labels."""
    from eigen_zkvm_tpu.recursion import aggregation as j_agg
    from eigen_zkvm_tpu_torch.bench_recursion import zkin_sha256

    out, r1 = {}, []
    for k, z in enumerate(zkins):
        proof, (st, c_ss, _) = j_c12.prove_compressed(
            z, setup, ss, j_c12.StarkOption(skip_main=True),
            n_queries=queries)
        cz = j_dict(proof, "GL")
        out[f"c12 {k}"] = zkin_sha256(cz)
        proof, (r1_setup, r1_ss, _) = j_c12.prove_compressed(
            cz, st, c_ss, j_c12.StarkOption(), n_queries=queries,
            force_n_bits=force)
        r1.append(j_dict(proof, "GL"))
        out[f"recursive1 {k}"] = zkin_sha256(r1[-1])
    final, _ = j_agg.aggregate_recursive1(
        r1, r1_setup, r1_ss, force_n_bits=force, n_queries=queries,
        chain_map=chain_map)
    out["aggregation"] = zkin_sha256(final)
    return out


def test_host_engine_gives_the_pinned_fibonacci_chain_digests():
    """The digests the card test of tests/test_torch_recursion_cuda.py
    holds its fibonacci chain to: the JAX package's host engine over the
    same two proofs, printed."""
    import test_torch_recursion_cuda as card

    zkins = [Fib(inputs).j_zkin for inputs in card.FIB_INPUTS]
    fib = Fib()
    got = _host_chain(zkins, fib.j_setup, fib.j_ss, card.FIB_QUERIES,
                      card.FIB_FORCE)
    print(got)
    assert got == card.FIB_CHAIN_SHA256


@pytest.mark.slow
def test_host_engine_gives_the_pinned_recursion_digests():
    """The digests chip_smoke.py's phase 10 holds its layers to: the JAX
    package's host engine proves the ecrecover guest's chunks 0 and 1
    (default_struct(16, 4), as tests/test_torch_rv32.py's pinned test),
    then c12, recursive1 at 2^18 and the chained aggregation of the two,
    4 queries each (scripts/zkvm_e2e.py:135-170); printed.  About ten
    minutes and 25 GB on the CPU."""
    import importlib.util

    from eigen_zkvm_tpu.zkvm import elf as j_elf
    from eigen_zkvm_tpu.zkvm import rv32 as j_rv32
    from eigen_zkvm_tpu.zkvm import rv32_native as j_native
    from eigen_zkvm_tpu.zkvm.lib import default_struct
    from eigen_zkvm_tpu_torch import bench_zkvm

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    program, entry, image0, ram_words, mem_base = j_elf.load_elf(
        bench_zkvm.read_guest(), include_exec_in_image=False)
    nc = j_native.NativeChunker(program, entry, n_bits=bench_zkvm.NBITS,
                                ram_words=ram_words, image0=image0,
                                mem_base=mem_base)
    m = j_rv32.Rv32Machine(program, bench_zkvm.NBITS, ram_words=ram_words,
                           mem_base=mem_base)
    ss = default_struct(bench_zkvm.NBITS, smoke.RECURSION_QUERIES)
    setup = j_setup.StarkSetup(m.const_pols, m.pil, ss)
    zkins = []
    for k in smoke.ZKVM_CHUNKS:
        states, image_in = nc.states_for(k)
        zkins.append(j_dict(j_gen.stark_gen(
            m.trace(states, image_in=image_in), m.const_pols,
            setup.const_tree, setup.starkinfo, setup.program, ss), "GL"))
    got = _host_chain(zkins, setup, ss, smoke.RECURSION_QUERIES,
                      smoke.RECURSION_FORCE, j_c12.ChainMap.for_machine(m))
    print(got)
    assert got == smoke.RECURSION_SHA256
