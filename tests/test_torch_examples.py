"""The port's copies of the Poseidon and simple-VM example AIRs
(eigen_zkvm_tpu_torch/examples/{poseidon,simple_vm}.py) against the JAX
package's, on the CPU: the PIL JSON, the constant pols, the trace and the
reference outputs; the port's proof byte-identical to the JAX host
engine's and accepted by the port's verifier; a flipped trace bit
rejected.  Through the port's CLI they give the zkin digests that
chip_smoke.py's phase 17 holds the card's proofs to (EXAMPLES_SHA256,
from the JAX host engine; the 2^16 one is recomputed by the slow test:

    JAX_PLATFORMS=cpu python -m pytest -p no:cacheprovider -m slow -s \
        tests/test_torch_examples.py
"""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.examples import poseidon as jposeidon
from eigen_zkvm_tpu.examples import simple_vm as jsimple_vm
from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu.stark.stark_verify import stark_verify as host_verify
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch import bench_chain, cli
from eigen_zkvm_tpu_torch.examples import poseidon, simple_vm
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.stark_verify import stark_verify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {"poseidon": (poseidon, jposeidon),
           "simple_vm": (simple_vm, jsimple_vm)}


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


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_ss(nbits: int, queries: int) -> StarkStruct:
    d = bench_chain.chain_struct_json(nbits, queries)
    return StarkStruct(nBits=d["nBits"], nBitsExt=d["nBitsExt"],
                       nQueries=d["nQueries"], verificationHashType="GL",
                       steps=[Step(s["nBits"]) for s in d["steps"]])


def _host_zkin(name: str, nbits: int, inputs, queries: int) -> str:
    """The JAX host engine's zkin text of the JAX module's AIR."""
    pil, cp, mk = MODULES[name][1].build(nbits)[:3]
    cm = mk(inputs)
    ss = _jax_ss(nbits, queries)
    setup = host_setup.StarkSetup(cp, pil, ss)
    proof = host_gen.stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                               setup.program, ss)
    assert host_verify(proof, setup.const_root, setup.starkinfo, ss,
                       setup.program)
    return stark_proof_to_json(proof)


@pytest.mark.parametrize("name,nbits", [("poseidon", 6), ("simple_vm", 10)])
def test_example_builds_the_jax_air(name, nbits):
    """PIL JSON, constants, trace and reference outputs equal the JAX
    module's for the smoke's inputs."""
    inputs = _smoke().example_inputs(name)
    port, jax_mod = MODULES[name]
    got, want = port.build(nbits), jax_mod.build(nbits)
    assert bench_chain.pil_to_json(got[0]) == \
        bench_chain.pil_to_json(want[0])
    assert np.array_equal(got[1].buffer, want[1].buffer)
    assert np.array_equal(got[2](inputs).buffer, want[2](inputs).buffer)
    # after make_trace: simple_vm's tape is a constant column
    assert np.array_equal(got[1].buffer, want[1].buffer)
    assert got[3](inputs) == want[3](inputs)


def test_poseidon_reference_digest_is_the_permutation():
    """The AIR's public digest is the engines' Poseidon: the JAX package's
    permutation of the same lanes."""
    from eigen_zkvm_tpu.hash import poseidon_gl as pnp

    inputs = _smoke().example_inputs("poseidon")
    ref = poseidon.build(6)[3]
    eng = pnp.permute(np.array([inputs[:8]], dtype=np.uint64),
                      np.array([inputs[8:]], dtype=np.uint64))[0]
    assert ref(inputs) == [int(x) for x in eng[:4]]


@pytest.mark.parametrize("name,nbits", [("poseidon", 6), ("simple_vm", 10)])
def test_example_proves_through_the_cli_to_the_host_digest(tmp_path, name,
                                                           nbits):
    """The smoke's files through the port's stark_prove: the zkin is the
    JAX host engine's text, its sha256 EXAMPLES_SHA256, and stark_verify
    accepts it."""
    smoke = _smoke()
    files = smoke.write_example_air(str(tmp_path), name, nbits)
    out = str(tmp_path / "zkin.json")
    assert cli.main(["stark_prove", "-s", files["struct"], "-p",
                     files["pil"], "-c", files["const"], "-m", files["cm"],
                     "-o", out, "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        text = f.read()
    want = _host_zkin(name, nbits, smoke.example_inputs(name),
                      smoke.ARG_QUERIES)
    assert text == want.encode()
    digest = hashlib.sha256(text).hexdigest()
    assert digest == smoke.EXAMPLES_SHA256[(name, nbits)], digest
    assert cli.main(["stark_verify", "-s", files["struct"], "-p",
                     files["pil"], "-c", files["const"], "-f", out,
                     "--device", "cpu"]) == 0


def test_poseidon_trace_with_a_flipped_bit_fails_to_verify():
    """tests/test_examples.py's tamper: a round output's bit flipped, the
    prove of either package is rejected by its verifier."""
    inputs = _smoke().example_inputs("poseidon")
    ss = _jax_ss(6, 2)
    pil, cp, mk, _ = poseidon.build(6)
    cm = mk(inputs)
    cm.buffer[5, 3] ^= np.uint64(1)
    engine = Engine("cpu")
    setup = StarkSetup(cp, pil, ss, engine)
    proof = stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                      setup.program, ss, engine=engine)
    assert not stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                            setup.program)
    jpil, jcp, jmk, _ = jposeidon.build(6)
    jcm = jmk(inputs)
    jcm.buffer[5, 3] ^= np.uint64(1)
    jsetup = host_setup.StarkSetup(jcp, jpil, ss)
    jproof = host_gen.stark_gen(jcm, jcp, jsetup.const_tree,
                                jsetup.starkinfo, jsetup.program, ss)
    assert not host_verify(jproof, jsetup.const_root, jsetup.starkinfo, ss,
                           jsetup.program)


@pytest.mark.slow
def test_host_engine_gives_the_pinned_example_digests():
    """chip_smoke.py phase 17 (b): every EXAMPLE_AIRS digest from the JAX
    host engine (seconds each on a CPU)."""
    smoke = _smoke()
    for name, nbits in smoke.EXAMPLE_AIRS:
        text = _host_zkin(name, nbits, smoke.example_inputs(name),
                          smoke.ARG_QUERIES)
        digest = hashlib.sha256(text.encode()).hexdigest()
        print(f"{name} 2^{nbits}: {digest}")
        assert digest == smoke.EXAMPLES_SHA256[(name, nbits)], digest
