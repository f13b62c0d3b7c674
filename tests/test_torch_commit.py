"""The port's commit backend (eigen_zkvm_tpu_torch/ops/commit.py) on CPU
tensors, against the host MerkleTreeGL and the JAX package's device commit
(ops/commit_tpu.py on the CPU backend), and the carrying of state between
the two packages (eigen_zkvm_tpu_torch/convert.py).  Bit-exact."""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eigen_zkvm_tpu.examples import fibonacci
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.ops import commit_tpu as ct
from eigen_zkvm_tpu.poly import ntt as ntt_np
from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu.stark.stark_verify import stark_verify
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch import convert
from eigen_zkvm_tpu_torch.hash.merkle import ZeroMerkleTreeGL
from eigen_zkvm_tpu_torch.ops import commit, gl
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

P = 0xFFFFFFFF00000001
CPU = torch.device("cpu")


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _proofs_match(tree, host, height):
    for idx in sorted({0, 1 % height, height // 2, height - 1}):
        v, mp = tree.get_group_proof(idx)
        assert MerkleTreeGL.verify_group_proof(host.root(), mp, idx, v)
        hv, hmp = host.get_group_proof(idx)
        assert np.array_equal(v, hv)
        assert len(mp) == len(hmp)
        assert all(np.array_equal(a, b) for a, b in zip(mp, hmp))


@pytest.mark.parametrize("height,width", [(1, 3), (13, 5), (256, 8)])
def test_tree_matches_host(height, width):
    buf = _rand(height, height, width)
    tree = commit.merkelize(gl.from_u64(buf))
    host = MerkleTreeGL().merkelize(buf, width, height)
    assert np.array_equal(tree.root(), host.root())
    _proofs_match(tree, host, height)


def test_tree_root_matches_jax_device_tree():
    """commit_tpu._levels_only on the CPU backend (one size: its XLA:CPU
    compile takes seconds per shape)."""
    height, width = 64, 8
    buf = _rand(4, height, width)
    lo, hi = ct._split(buf)
    flat = ct._levels_only(jnp.asarray(lo), jnp.asarray(hi), width, height)
    _, offsets = ct._level_meta(height)
    assert np.array_equal(commit.merkelize(gl.from_u64(buf)).root(),
                          ct._join(flat[0][offsets[-1]],
                                   flat[1][offsets[-1]]))


def test_extend_and_merkelize_matches_host_lde_and_tree():
    nbits, width = 6, 4
    buf = _rand(1, 1 << nbits, width)
    tree = commit.extend_and_merkelize(gl.from_u64(buf), nbits, nbits + 1)
    lde = ntt_np.interpolate(buf, nbits, nbits + 1)
    host = MerkleTreeGL().merkelize(lde, width, 1 << (nbits + 1))
    assert np.array_equal(tree.elements, lde)     # lazily fetched
    assert np.array_equal(tree.to_extend(), lde)
    assert np.array_equal(tree.root(), host.root())
    _proofs_match(tree, host, 1 << (nbits + 1))
    # a width-0 section commits the zero tree (one digest per level), whose
    # root and proofs are the host tree's over a [height, 0] matrix
    empty = commit.extend_and_merkelize(
        gl.from_u64(np.zeros((1 << nbits, 0), np.uint64)), nbits, nbits + 1)
    height = 1 << (nbits + 1)
    host_empty = MerkleTreeGL().merkelize(np.zeros((height, 0), np.uint64),
                                          0, height)
    assert isinstance(empty, ZeroMerkleTreeGL)
    assert np.array_equal(empty.root(), host_empty.root())
    _proofs_match(empty, host_empty, height)


def test_prefetch_batches_queries_and_pickle_roundtrip():
    nbits = 5
    tree = commit.extend_and_merkelize(gl.from_u64(_rand(2, 1 << nbits, 3)),
                                       nbits, nbits + 1)
    tree.prefetch([3, 17, 3, 60])
    assert sorted(tree._pref) == [3, 17, 60]
    back = pickle.loads(pickle.dumps(tree))
    assert isinstance(back._nodes, torch.Tensor)
    assert np.array_equal(back.root(), tree.root())
    assert np.array_equal(back.elements, tree.elements)
    for idx in (0, 17, 63):
        v, mp = back.get_group_proof(idx)
        assert MerkleTreeGL.verify_group_proof(tree.root(), mp, idx, v)
    with pytest.raises(IndexError):
        tree.get_group_proof(64)


def test_limb_pairs_roundtrip():
    x = _rand(3, 7, 5)
    lo, hi = ct._split(x)
    t = convert.from_limb_pair(jnp.asarray(lo), jnp.asarray(hi))
    assert np.array_equal(gl.to_u64(t), x)
    lo2, hi2 = convert.to_limb_pair(t)
    assert lo2.dtype == np.uint32 and np.array_equal(lo2, lo)
    assert np.array_equal(hi2, hi)


SS = StarkStruct(nBits=5, nBitsExt=6, nQueries=3,
                 verificationHashType="GL", steps=[Step(6), Step(3)])


@pytest.mark.parametrize("jax_commit", ["0", "1"])
def test_setup_from_jax_proves_like_both_packages(monkeypatch, tmp_path,
                                                  jax_commit):
    """A JAX-package setup (host tree, or commit_tpu's device tree on the
    CPU backend) carried to the port proves the same bytes as the JAX
    package's host prove; the port's setup survives save/load."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    monkeypatch.setenv("EIGEN_ZKVM_TPU_COMMIT", jax_commit)
    pil, cp, mk = fibonacci.build(5)
    cm = mk()
    jsetup = host_setup.StarkSetup(cp, pil, SS)
    assert isinstance(jsetup.const_tree, ct.DeviceMerkleTreeGL) \
        == (jax_commit == "1")
    monkeypatch.setenv("EIGEN_ZKVM_TPU_COMMIT", "0")
    want = stark_proof_to_json(host_gen.stark_gen(
        cm, cp, jsetup.const_tree, jsetup.starkinfo, jsetup.program, SS))
    setup = convert.setup_from_jax(jsetup, CPU)
    assert isinstance(setup.const_tree, commit.DeviceMerkleTreeGL)
    assert np.array_equal(setup.const_root, jsetup.const_root)
    path = str(tmp_path / "setup.pkl")
    setup.save(path)
    setup = StarkSetup.load(path)
    engine = Engine(CPU)
    proof = stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                      setup.program, SS, engine=engine)
    assert stark_verify(proof, setup.const_root, setup.starkinfo, SS,
                        setup.program)
    assert stark_proof_to_json(proof) == want
