"""Big-field eSTARK proves (BN128 / BLS12381) of the port against the JAX
package's host engine.

The same AIR, constants, trace and starkStruct go through
eigen_zkvm_tpu's StarkSetup + stark_gen (EIGEN_ZKVM_ENGINE=host: its
native Poseidon-Fr) and through the port's (Engine("cpu"): the plain
versions of the kernels); the proof JSON must be byte-identical and the
port's stark_verify must give the JAX verifier's answer: True, or False
for the AIRs with a section of width 4 (examples/connection.py's four
constant columns, examples/plookup.py's four committed ones), which the JAX
package's verifier rejects under a big-field hash and the port reproduces.
The test marked cuda proves chip_smoke.py's phase-9 chain AIR on the card
(python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_prove_bigfield.py).
"""
import hashlib
import importlib
import importlib.util
import json
import os
import pickle

import pytest
import torch

from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu.stark.stark_verify import stark_verify as host_verify
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch import bench_chain, cli, convert, kernels
from eigen_zkvm_tpu_torch.hash import linearhash_big as lh
from eigen_zkvm_tpu_torch.hash import poseidon_bn128
from eigen_zkvm_tpu_torch.stark import serializer as port_serializer
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.stark_verify import stark_verify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain big-field permutation is many small tensor operations:
    torch's intra-op threads gain nothing on them here and contend with the
    other test workers' processes for the cores, so these tests run on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    return _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def _jax_ss(nbits: int, hash_type: str, queries: int = 4,
            steps: str = "final") -> StarkStruct:
    d = bench_chain.chain_struct_json(nbits, queries, hash_type, steps)
    return StarkStruct(nBits=d["nBits"], nBitsExt=d["nBitsExt"],
                       nQueries=d["nQueries"],
                       verificationHashType=hash_type,
                       steps=[Step(s["nBits"]) for s in d["steps"]])


def _air(name: str, nbits: int, package: str):
    """(pil, const_pols, cm_pols) of the chain AIR (12 columns) or an
    example AIR, built by the JAX package or by the port."""
    if name == "chain":
        if package == "jax":
            bench_big = _load("bench_big",
                              os.path.join(ROOT, "scripts", "bench_big.py"))
            return bench_big.build_chain_air(nbits, 12)
        return bench_chain.build_chain_air(nbits, 12)
    pkg = "eigen_zkvm_tpu" if package == "jax" else "eigen_zkvm_tpu_torch"
    pil, cp, mk = importlib.import_module(f"{pkg}.examples.{name}").build(
        nbits)
    return pil, cp, mk()


def _host(name: str, nbits: int, ss):
    pil, cp, cm = _air(name, nbits, "jax")
    setup = host_setup.StarkSetup(cp, pil, ss)
    proof = host_gen.stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                               setup.program, ss)
    ok = host_verify(proof, setup.const_root, setup.starkinfo, ss,
                     setup.program)
    return setup, stark_proof_to_json(proof, ss.verificationHashType), ok


def _port(name: str, nbits: int, ss):
    pil, cp, cm = _air(name, nbits, "port")
    engine = Engine("cpu")
    setup = StarkSetup(cp, pil, ss, engine)
    proof = stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                      setup.program, ss, engine=engine)
    return setup, proof


CASES = [("chain", 5, "BN128"), ("chain", 8, "BN128"),
         ("chain", 5, "BLS12381"), ("chain", 8, "BLS12381"),
         ("permutation", 5, "BN128"), ("connection", 5, "BN128"),
         ("plookup", 5, "BN128")]


@pytest.mark.parametrize("name,nbits,hash_type", CASES)
def test_port_proof_is_byte_identical_to_host_engine(monkeypatch, name,
                                                     nbits, hash_type):
    """stark_gen's proof JSON equals the host engine's, and the port's
    verifier gives the JAX verifier's answer (False for the width-4
    sections of connection and plookup, True otherwise)."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    ss = _jax_ss(nbits, hash_type)
    _, want, host_ok = _host(name, nbits, ss)
    assert host_ok == (name not in ("connection", "plookup"))
    before = kernels.counts()
    setup, proof = _port(name, nbits, ss)
    assert kernels.counts() == before   # CPU tensors: plain versions only
    assert port_serializer.stark_proof_to_json(proof, hash_type) == want
    assert stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program) == host_ok


def _bump(row: list, i: int):
    row[i] = str(int(row[i]) ^ 1)


def test_port_verifier_gives_the_jax_answer_on_changed_proofs(monkeypatch):
    """A changed eval, FRI root, top-level sibling or query value is
    rejected by both verifiers.  A changed sibling below the top level
    (not the leaf's own slot) is accepted by both: the JAX package's
    calculate_root_from_proof hashes each level's 16 digests without
    checking that the level below hashes to its slot, and the port keeps
    that behaviour."""
    from eigen_zkvm_tpu.stark.serializer import stark_proof_from_dict as jd

    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    ss = _jax_ss(8, "BN128")
    setup, proof = _port("chain", 8, ss)
    jpil, jcp, _ = _air("chain", 8, "jax")
    hsetup = host_setup.StarkSetup(jcp, jpil, ss)
    args = (setup.const_root, setup.starkinfo, ss, setup.program)
    text = port_serializer.stark_proof_to_json(proof, "BN128")
    d0 = json.loads(text)
    assert len(d0["s0_siblings1"][0]) >= 2
    # the first query's leaf slot in tree 1's first level
    leaf = lh.hash_element_matrix(poseidon_bn128.POSEIDON, [d0["s0_vals1"][0]])
    slot = d0["s0_siblings1"][0][0].index(str(leaf))
    changes = {
        "evals": (lambda d: _bump(d["evals"][0], 1), False),
        "s1_root": (lambda d: d.__setitem__("s1_root",
                                            str(int(d["s1_root"]) ^ 1)),
                    False),
        "top sibling": (lambda d: _bump(d["s0_siblings1"][0][-1], 3), False),
        "query value": (lambda d: _bump(d["s0_vals1"][0], 0), False),
        "lower sibling": (lambda d: _bump(d["s0_siblings1"][0][0],
                                          (slot + 1) % 16), True),
        "none": (lambda d: None, True),
    }
    for key, (change, accepted) in changes.items():
        d = json.loads(text)
        change(d)
        got = stark_verify(port_serializer.stark_proof_from_dict(d), *args)
        want = host_verify(jd(d), hsetup.const_root, hsetup.starkinfo, ss,
                           hsetup.program)
        assert got == want == accepted, key


def test_setup_from_jax_proves_to_the_same_bytes(monkeypatch, tmp_path):
    """A JAX-package BN128 StarkSetup (its host MerkleTreeBN128 const tree)
    carried over by convert.setup_from_jax, nodes copied: the port proves
    to the host engine's bytes from it, and it pickles and loads back."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    ss = _jax_ss(5, "BN128")
    jsetup, want, _ = _host("permutation", 5, ss)
    setup = convert.setup_from_jax(jsetup, "cpu")
    assert setup.const_tree.root() == jsetup.const_root
    assert setup.const_tree.levels() == jsetup.const_tree.levels
    pil, cp, cm = _air("permutation", 5, "port")
    path = str(tmp_path / "setup.pkl")
    setup.save(path)
    for s in (setup, StarkSetup.load(path)):
        proof = stark_gen(cm, cp, s.const_tree, s.starkinfo, s.program, ss,
                          engine=Engine("cpu"))
        assert port_serializer.stark_proof_to_json(proof, "BN128") == want


@pytest.mark.parametrize("hash_type", ["BN128", "BLS12381"])
def test_cli_stark_prove_with_a_big_field_struct(monkeypatch, tmp_path,
                                                 hash_type):
    """A BN128 / BLS12381 starkStruct file through the port's command line
    on the CPU: it proves, self-verifies, writes the host engine's zkin
    bytes, and stark_verify accepts them."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    files = bench_chain.write_chain_files(str(tmp_path), 5, 12, 4, hash_type,
                                          "final")
    out = str(tmp_path / "zkin.json")
    assert cli.main(["stark_prove", "-s", files["stark_struct"], "-p",
                     files["pil"], "-c", files["const"], "-m", files["cm"],
                     "-o", out, "--device", "cpu"]) == 0
    _, want, _ = _host("chain", 5, _jax_ss(5, hash_type))
    with open(out) as f:
        assert f.read() == want
    assert cli.main(["stark_verify", "-s", files["stark_struct"], "-p",
                     files["pil"], "-c", files["const"], "-f", out,
                     "--device", "cpu"]) == 0


@pytest.mark.parametrize("case", ["chain BN128", "chain BLS12381",
                                  "permutation BN128"])
def test_host_engine_gives_the_pinned_bigfield_digests(monkeypatch, case):
    """chip_smoke.py phase 9's zkins: the JAX package's host engine proves
    the same AIR and struct (2^16 -> 2^17, 8 queries, steps 17, 13, 9, 5)
    to the digest the card's prove is held to."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    smoke = _smoke()
    name, hash_type = case.split()
    nbits = smoke.BIGFIELD_NBITS
    ss = _jax_ss(nbits, hash_type, smoke.BIGFIELD_QUERIES)
    assert [s.nBits for s in ss.steps] == [17, 13, 9, 5]
    _, text, ok = _host(name, nbits, ss)
    assert ok
    digest = hashlib.sha256(text.encode()).hexdigest()
    assert digest == smoke.BIGFIELD_SHA256[(name, hash_type)], digest


@pytest.mark.cuda
def test_port_on_the_card_gives_the_pinned_digest(tmp_path):
    """Phase 9's BN128 chain AIR through the port's stark_prove on the
    card: the zkin's sha256 is the pinned host-engine digest, and the
    Poseidon-Fr kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eigen_zkvm_tpu_torch.stark.prove import stark_prove

    smoke = _smoke()
    files = bench_chain.write_chain_files(
        str(tmp_path), smoke.BIGFIELD_NBITS, 12, smoke.BIGFIELD_QUERIES,
        "BN128", "final")
    out = str(tmp_path / "zkin.json")
    before = kernels.POSEIDON_FR.launches
    stark_prove(files["stark_struct"], files["pil"], files["const"],
                files["cm"], zkin_out=out)
    assert kernels.POSEIDON_FR.launches > before
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert digest == smoke.BIGFIELD_SHA256[("chain", "BN128")]


def test_setup_pickle_keeps_the_big_tree(tmp_path):
    ss = _jax_ss(5, "BLS12381")
    pil, cp, _ = _air("chain", 5, "port")
    setup = StarkSetup(cp, pil, ss, Engine("cpu"))
    path = str(tmp_path / "s.pkl")
    setup.save(path)
    with open(path, "rb") as f:
        back = pickle.load(f)
    assert back.const_tree.root() == setup.const_root
    assert back.const_tree.get_group_proof(7)[1] == \
        setup.const_tree.get_group_proof(7)[1]
