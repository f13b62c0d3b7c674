"""The port's circom-subset compiler (eigen_zkvm_tpu_torch/dsl/) against
the JAX package's (eigen_zkvm_tpu/dsl/) on the CPU, tolerance 0: every
value is a field element.

Every source of tests/test_circom_dsl.py, test_simplify.py and
test_cli_compile.py, and the committed data/circuits/ chains at N = 16,
go through both compilers: the constraints, witness, publics,
custom-gate records and .sym entries are equal, so are the .r1cs, .wtns
and .sym bytes, and so are `simplify`'s statistics and result at O0, O1
and O2.  Input outside the subset raises the same exception with the same
message in both; a tampered witness fails check() in both; an include
resolves over the search paths alike.  The Multiplier and Num2Bits
circuits prove through the port's Groth16 (device "cpu", seeded draws) to
the JAX package's proof JSON; a Goldilocks compile gives the JAX
package's PlonkSetup and exec_witness buffers; the CLI's `compile` writes
the JAX CLI's files and lines.  The compile -> compressor12 prove is in
test_torch_circom_c12.py.  One torch thread.
"""
import copy
import os

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu import cli as j_cli
from eigen_zkvm_tpu.algebraic import r1cs_file as j_r1cs
from eigen_zkvm_tpu.algebraic import witness as j_wit
from eigen_zkvm_tpu.curves import bn254 as j_bn
from eigen_zkvm_tpu.dsl import elaborate as j_elab
from eigen_zkvm_tpu.dsl import simplify as j_simp
from eigen_zkvm_tpu.groth16 import api as j_api
from eigen_zkvm_tpu.groth16 import groth16 as j_g16
from eigen_zkvm_tpu.recursion import plonk_setup as j_plonk
from eigen_zkvm_tpu_torch import bench_circom as bc
from eigen_zkvm_tpu_torch import bench_groth16 as bg
from eigen_zkvm_tpu_torch import cli, convert
from eigen_zkvm_tpu_torch.algebraic import r1cs_file, witness
from eigen_zkvm_tpu_torch.dsl import elaborate, simplify
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.recursion import plonk_setup

from test_circom_dsl import CUSTOM_CMULADD, INV_FN, MULTIPLIER, NUM2BITS
from test_cli_compile import PARAM_CUSTOM
from test_cli_compile import SRC as PYTHAG
from test_simplify import NUM2BITS as NUM2BITS_S

GL = 0xFFFFFFFF00000001
R = j_bn.R
CMULADD_INPUTS = {"a": [3, 4, 5], "b": [7, 8, 9], "c": [10, 11, 12]}
# name -> (source, inputs, prime)
SOURCES = {
    "multiplier": (MULTIPLIER, {"a": 3, "b": 11}, R),
    "multiplier_gl": (MULTIPLIER, {"a": 6, "b": 7}, GL),
    "num2bits": (NUM2BITS, {"x": 0b10110101}, R),
    "num2bits_simplify": (NUM2BITS_S, {"x": 77}, R),
    "inv_fn": (INV_FN, {"in": 987654321}, R),
    "custom_cmuladd": (CUSTOM_CMULADD, CMULADD_INPUTS, GL),
    "pythag": (PYTHAG, {"a": 3, "b": 4}, R),
    "param_custom": (PARAM_CUSTOM, {"a": 3}, GL),
    "glmul_16": (bc.source(bc.GLMUL, 16), bc.GLMUL_INPUTS, R),
    "glsquare_16": (bc.source(bc.GLSQUARE, 16), bc.GLSQUARE_INPUTS, GL),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name: str):
    src, inputs, prime = SOURCES[name]
    return (elaborate.compile_circom(src, inputs, prime=prime),
            j_elab.compile_circom(src, inputs, prime=prime))


def _state(b) -> tuple:
    return (b.P, b.n_vars, b.n_publics, list(b.w), list(b.constraints),
            list(b.custom_gates), list(getattr(b, "sym", [])))


def _files(b, mod_r1cs, mod_wit, write_sym, path) -> tuple:
    write_sym(b, path)
    with open(path) as f:
        sym = f.read()
    return (mod_r1cs.to_bytes(mod_r1cs.circuit_to_r1cs(b)),
            mod_wit.witness_to_bytes(b.w, b.P), sym)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compile_and_simplify_equal_the_jax_package(tmp_path, name):
    port, jax = _both(name)
    assert _state(port) == _state(jax)
    # check() is False for a gate it does not know (param_custom's Scale)
    assert port.check() == jax.check() == (name != "param_custom")
    for level in (0, 1, 2):
        p, j = copy.deepcopy(port), copy.deepcopy(jax)
        assert simplify.simplify(p, level) == j_simp.simplify(j, level)
        assert _state(p) == _state(j), level
        assert p.check() == j.check() == (name != "param_custom")
        got = _files(p, r1cs_file, witness, elaborate.write_sym,
                     str(tmp_path / f"p{level}.sym"))
        assert got == _files(j, j_r1cs, j_wit, j_elab.write_sym,
                             str(tmp_path / f"j{level}.sym"))


def test_glmul_chain_is_the_committed_shape():
    b = elaborate.compile_circom(bc.source(bc.GLMUL, 16), bc.GLMUL_INPUTS,
                                 prime=R)
    assert (len(b.constraints), b.n_publics) == (2097, 2)
    x, y = bc.GLMUL_INPUTS["x"], bc.GLMUL_INPUTS["y"]
    assert b.w[1:3] == [x * pow(y, 16, GL) % GL, x]   # out, then x
    st = simplify.simplify(b, 2)
    assert st["constraints_after"] == 129 * 16


COMPONENT_ARRAY = r"""
template Num2Bits(n) {
    signal input in;
    signal output out[n];
    var lc1 = 0;
    var e2 = 1;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        lc1 += out[i] * e2;
        e2 = e2 + e2;
    }
    lc1 === in;
}
template Main() {
    signal input x[2];
    component nb[2];
    for (var i = 0; i < 2; i++) {
        nb[i] = Num2Bits(64);
        nb[i].in <== x[i];
    }
}
component main = Main();
"""
QUAD_BOTH_SIDES = r"""
template T() {
    signal input a;
    signal input b;
    signal input c;
    signal input d;
    a * b === c * d;
}
component main = T();
"""
CUBIC = r"""
template T() {
    signal input a;
    signal input b;
    signal input c;
    signal output d;
    d <== a * b * c;
}
component main = T();
"""


@pytest.mark.parametrize("src, inputs, exc", [
    (COMPONENT_ARRAY, {"x": [1, 2]}, KeyError),
    (QUAD_BOTH_SIDES, {"a": 2, "b": 3, "c": 1, "d": 6}, ValueError),
    (CUBIC, {"a": 2, "b": 3, "c": 4}, ValueError),
    ("template T() { signal input a; @ }\ncomponent main = T();", {},
     SyntaxError),
], ids=["component_array", "quadratic_both_sides", "cubic", "bad_token"])
def test_unsupported_input_raises_the_jax_exception(src, inputs, exc):
    with pytest.raises(exc) as want:
        j_elab.compile_circom(src, inputs, prime=R)
    with pytest.raises(exc) as got:
        elaborate.compile_circom(src, inputs, prime=R)
    assert str(got.value) == str(want.value)


def test_tampered_witness_fails_check_in_both():
    for b in _both("multiplier"):
        assert b.check()
        b.w[1] = 34    # the public output
        assert not b.check()


def test_include_over_search_paths_compiles_alike(tmp_path):
    lib = tmp_path / "lib"
    lib.mkdir()
    (lib / "n2b.circom").write_text(
        NUM2BITS.split("template Main")[0])
    src = 'pragma circom 2.0.0;\ninclude "n2b.circom";\n' + \
        "template Main" + NUM2BITS.split("template Main")[1]
    port = elaborate.compile_circom(src, {"x": 201}, search_paths=[str(lib)],
                                    prime=R)
    jax = j_elab.compile_circom(src, {"x": 201}, search_paths=[str(lib)],
                                prime=R)
    assert _state(port) == _state(jax)
    assert port.check()
    with pytest.raises(KeyError):   # not found without the path
        elaborate.compile_circom(src, {"x": 201}, prime=R)


@pytest.mark.parametrize("name", ["multiplier", "num2bits"])
def test_groth16_proof_json_is_the_jax_packages(name):
    port, jax = _both(name)
    jpk, jvk = j_g16.setup(j_bn, jax.constraints, jax.n_vars, jax.n_publics,
                           rng=bg.seeded(11))
    jproof, jpubs = j_g16.prove(j_bn, jpk, jax.constraints, jax.w,
                                rng=bg.seeded(12))
    pk, vk = api.groth16_setup_inplace("bn128", port, rng=bg.seeded(11),
                                       device="cpu")
    proof, pubs = api.groth16_prove_inplace("bn128", port, pk,
                                            rng=bg.seeded(12))
    assert api.vk_to_json(vk) == j_api.vk_to_json(jvk)
    assert api.proof_to_json(proof, "bn128") == \
        j_api.proof_to_json(jproof, "bn128")
    assert pubs == jpubs
    assert api.groth16_verify_inplace("bn128", vk, proof, pubs)
    bad = list(pubs)
    bad[0] = (bad[0] + 1) % R
    assert not api.groth16_verify_inplace("bn128", vk, proof, bad)


@pytest.mark.parametrize("name", ["multiplier_gl", "custom_cmuladd",
                                  "glsquare_16"])
def test_goldilocks_compile_gives_the_jax_plonk_buffers(name):
    port, jax = _both(name)
    ps, jps = plonk_setup.PlonkSetup(port), j_plonk.PlonkSetup(jax)
    want = convert.plonk_setup_from_jax(jps)
    assert (ps.n_bits, ps.n_used, ps.n_publics) == \
        (want.n_bits, want.n_used, want.n_publics)
    assert np.array_equal(ps.const_pols.buffer, want.const_pols.buffer)
    assert np.array_equal(ps.s_map, want.s_map)
    cm = plonk_setup.exec_witness(port, ps)
    assert np.array_equal(cm.buffer, j_plonk.exec_witness(jax, jps).buffer)


@pytest.mark.parametrize("prime, opt", [
    ("bn128", 0), ("bn128", 2), ("goldilocks", 2), ("bls12381", 1)])
def test_cli_compile_writes_the_jax_clis_files(tmp_path, capsys, prime, opt):
    circ = tmp_path / "py.circom"
    circ.write_text(PYTHAG)
    inp = tmp_path / "in.json"
    inp.write_text('{"a": 3, "b": 4}')
    out, lines = {}, {}
    for side, main in (("jax", j_cli.main), ("port", cli.main)):
        base = str(tmp_path / side)
        main(["compile", "-i", str(circ), "--input", str(inp), "-o", base,
              "-O", str(opt), "-p", prime])
        lines[side] = capsys.readouterr().out.replace(base, "BASE")
        out[side] = []
        for ext in (".r1cs", ".wtns", ".sym"):
            with open(base + ext, "rb") as f:
                out[side].append(f.read())
    assert out["port"] == out["jax"]
    assert lines["port"] == lines["jax"]
    assert ("simplify O" in lines["port"]) == (opt > 0)
    assert os.path.getsize(str(tmp_path / "port.r1cs")) > 0
