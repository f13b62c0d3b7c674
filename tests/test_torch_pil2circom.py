"""The port's render of the STARK verifier as circom text
(eigen_zkvm_tpu_torch/stark/pil2circom{,_onchain}.py) against the JAX
package's, byte for byte, on the CPU.

Each package sets up the example AIRs (examples/{fibonacci,permutation,
plookup,connection}.py, both packages' copies) at 2^5 rows on its own,
under the GL hash and under BN128 and BLS12381, and renders their
verifiers with every StarkOption a test names; the port's stark_prove
writes the JAX function's file (`circom_out`, norm_stage on by default),
and the port's CLI `stark_prove --circom` the JAX CLI's file for every
combination of --agg_stage, --norm_stage and --skip_main (--norm_stage off
by default there).  A recursion layer's render (the fibonacci c12 setup)
is held in tests/test_torch_recursion_r1.py, which builds that setup.
The JAX package proves on its host engine; the port on the CPU, one torch
thread.
"""
import importlib
import itertools
import json

import pytest
import torch

from eigen_zkvm_tpu import cli as j_cli
from eigen_zkvm_tpu.stark import pil2circom as j_p2c
from eigen_zkvm_tpu.stark import prove as j_prove
from eigen_zkvm_tpu.stark import types as j_types
from eigen_zkvm_tpu.stark.stark_setup import StarkSetup as JStarkSetup
from eigen_zkvm_tpu_torch import bench_chain, cli
from eigen_zkvm_tpu_torch.stark import pil2circom
from eigen_zkvm_tpu_torch.stark import prove
from eigen_zkvm_tpu_torch.stark import types
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

NBITS, QUERIES = 5, 4
AIRS = ("fibonacci", "permutation", "plookup", "connection")
HASHES = ("GL", "BN128", "BLS12381")
# (enable_input, verkey_input, skip_main, agg_stage)
GL_OPTIONS = [(False, False, False, False), (True, True, False, False),
              (False, False, True, False), (False, True, False, True)]
BIG_OPTIONS = GL_OPTIONS[:3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    """The JAX package's host engine: it never probes for a TPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")


def _setups(name: str, hash_type: str):
    """(JAX (pil, setup, struct), port (pil, setup, struct)) of one
    example AIR, each package's own build and setup."""
    ss = bench_chain.chain_struct_json(NBITS, QUERIES, hash_type)
    j_pil, j_cp, _ = importlib.import_module(
        f"eigen_zkvm_tpu.examples.{name}").build(NBITS)
    pil, cp, _ = importlib.import_module(
        f"eigen_zkvm_tpu_torch.examples.{name}").build(NBITS)
    j_ss, p_ss = j_types.StarkStruct.from_json(ss), \
        types.StarkStruct.from_json(ss)
    return ((j_pil, JStarkSetup(j_cp, j_pil, j_ss), j_ss),
            (pil, StarkSetup(cp, pil, p_ss, Engine("cpu")), p_ss))


def _render(mod, pil, setup, ss, opt):
    return mod.pil2circom(pil, setup.const_root, ss, setup.starkinfo,
                          setup.program, mod.StarkOption(*opt))


@pytest.mark.parametrize("hash_type", HASHES)
@pytest.mark.parametrize("name", AIRS)
def test_example_air_render_is_the_jax_text(name, hash_type):
    (j_pil, j_setup, j_ss), (pil, setup, ss) = _setups(name, hash_type)
    texts = []
    for opt in GL_OPTIONS if hash_type == "GL" else BIG_OPTIONS:
        want = _render(j_p2c, j_pil, j_setup, j_ss, opt)
        got = _render(pil2circom, pil, setup, ss, opt)
        assert got == want, opt
        texts.append(got)
    assert len(set(texts)) == len(texts)
    header = texts[0].splitlines()[0]
    assert header == ("pragma circom 2.1.0;" if hash_type == "GL"
                      else "pragma circom 2.0.6;")
    if hash_type != "GL":
        # the big-field render takes agg_stage as verkey_input, as the
        # JAX package's does
        agg = (False, True, False, True)
        assert _render(pil2circom, pil, setup, ss, agg) == \
            _render(j_p2c, j_pil, j_setup, j_ss, agg) == \
            _render(pil2circom, pil, setup, ss, (False, True, False, False))


def _write_files(d, hash_type: str) -> dict:
    """The fibonacci AIR's files (the JAX CLI's PIL writer) at 2^5."""
    from eigen_zkvm_tpu.examples import fibonacci

    pil, cp, mk = fibonacci.build(NBITS)
    files = {k: str(d / f"air.{k}") for k in ("pil", "struct", "const", "cm")}
    with open(files["pil"], "w") as f:
        json.dump(j_cli._pil_to_json(pil), f)
    with open(files["struct"], "w") as f:
        json.dump(bench_chain.chain_struct_json(NBITS, 3, hash_type), f)
    cp.save(files["const"])
    mk().save(files["cm"])
    return files


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("hash_type", ["GL", "BN128"])
def test_stark_prove_writes_the_jax_functions_circom_file(tmp_path,
                                                          hash_type):
    files = _write_files(tmp_path, hash_type)
    args = (files["struct"], files["pil"], files["const"], files["cm"])
    out = {}
    for side, fn, extra in (("jax", j_prove.stark_prove, {}),
                            ("port", prove.stark_prove, {"device": "cpu"})):
        out[side] = str(tmp_path / f"{side}.circom")
        fn(*args, zkin_out=str(tmp_path / f"{side}.json"),
           circom_out=out[side], **extra)
    assert _read(out["port"]) == _read(out["jax"])
    assert _read(str(tmp_path / "port.json")) == \
        _read(str(tmp_path / "jax.json"))


FLAGS = ("--agg_stage", "--norm_stage", "--skip_main")


@pytest.mark.parametrize("hash_type", ["GL", "BN128"])
@pytest.mark.parametrize("flags", [
    list(itertools.compress(FLAGS, bits))
    for bits in itertools.product((0, 1), repeat=3)],
    ids=lambda f: "+".join(x[2:] for x in f) or "defaults")
def test_cli_stark_prove_circom_is_the_jax_clis_file(tmp_path, flags,
                                                     hash_type):
    files = _write_files(tmp_path, hash_type)
    args = ["stark_prove", "-s", files["struct"], "-p", files["pil"],
            "-c", files["const"], "-m", files["cm"]]
    out = {side: str(tmp_path / f"{side}.circom") for side in ("jax", "port")}
    j_cli.main([*args, "-o", str(tmp_path / "jax.json"),
                "--circom", out["jax"], *flags])
    assert cli.main([*args, "-o", str(tmp_path / "port.json"),
                     "--circom", out["port"], "--device", "cpu",
                     *flags]) == 0
    assert _read(out["port"]) == _read(out["jax"])
