"""The port's host-side hashing (eigen_zkvm_tpu_torch/hash/) and scalar field
helpers (ops/gl.py) against the JAX package's: the scalar Poseidon against
hash/poseidon_gl.py, the transcript against hash/transcript_gl.py, the leaf
hash, proof checks and zero tree against hash/merkle_gl.py and
hash/linearhash_gl.py.  Inputs are made with numpy from a seed; bit-exact."""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.fields import gl64
from eigen_zkvm_tpu.hash import linearhash_gl, poseidon_gl
from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
from eigen_zkvm_tpu.hash.merkle_gl import ZeroMerkleTreeGL as HostZeroTree
from eigen_zkvm_tpu.hash.transcript_gl import TranscriptGL as HostTranscript
from eigen_zkvm_tpu.poly import ntt as ntt_np
from eigen_zkvm_tpu_torch.hash import merkle, poseidon
from eigen_zkvm_tpu_torch.hash.transcript import TranscriptGL
from eigen_zkvm_tpu_torch.ops import gl

P = gl64.P_INT


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def test_constants_are_the_jax_packages():
    for name in ("C", "M", "PMAT", "S"):
        assert np.array_equal(getattr(poseidon, name),
                              getattr(poseidon_gl, name)), name


def test_scalar_permutation_matches_host():
    st = _rand(1, 6, 12)
    want = poseidon_gl.permute(st[:, :8], st[:, 8:])
    for row, w in zip(st, want):
        assert poseidon.permute([int(x) for x in row]) == [int(x) for x in w]


def test_transcript_matches_host():
    vals = _rand(2, 40)
    a, b = TranscriptGL(), HostTranscript()
    for chunk in (vals[:3], vals[3:11], vals[11:12], vals[12:40]):
        a.put(chunk)
        b.put(chunk)
        assert np.array_equal(a.get_field(), b.get_field())
        assert a.get_fields1() == b.get_fields1()
    a.put_root(vals[:4])
    b.put_root(vals[:4])
    assert a.get_permutations(13, 21) == b.get_permutations(13, 21)


@pytest.mark.parametrize("width", [0, 3, 4, 5, 8, 13, 36, 97])
def test_leaf_hash_matches_linearhash(width):
    rows = _rand(width, 3, width)
    want = linearhash_gl.hash_leaves(rows, batch_size=0)
    for r, w in zip(rows, want):
        assert merkle.hash_leaf(r) == [int(x) for x in w]


def test_proof_checks_match_host_tree():
    height, width = 12, 7
    buf = _rand(3, height, width)
    host = MerkleTreeGL().merkelize(buf, width, height)
    for idx in (0, 5, 11):
        v, mp = host.get_group_proof(idx)
        assert merkle.calculate_root_from_proof(
            mp, idx, merkle.hash_leaf(v)) == [int(x) for x in host.root()]
        assert merkle.verify_group_proof(host.root(), mp, idx, v)
        assert not merkle.verify_group_proof(host.root(), mp, idx ^ 1, v)


@pytest.mark.parametrize("height", [1, 2, 64])
def test_zero_tree_matches_host(height):
    tree = merkle.ZeroMerkleTreeGL.build(height)
    host = HostZeroTree.build(height)
    assert np.array_equal(tree.root(), host.root())
    v, mp = tree.get_group_proof(height - 1)
    hv, hmp = host.get_group_proof(height - 1)
    assert v.shape == hv.shape == (0,)
    assert all(np.array_equal(a, b) for a, b in zip(mp, hmp))
    assert merkle.verify_group_proof(tree.root(), mp, height - 1, v)


def test_scalar_field_helpers_match_gl64():
    for nbits in (0, 1, 5, 20, 32):
        assert gl.root_of_unity(nbits) == gl64.root_of_unity(nbits)
    assert gl.SHIFT == gl64.SHIFT
    a, b = int(_rand(4, 1)[0]), int(_rand(5, 1)[0])
    assert gl.mul_int(a, b) == int(gl64.mul(np.uint64(a), np.uint64(b)))
    assert gl.inv_int(a) == int(gl64.inv(np.uint64(a)))
    assert gl.exp_int(a, 12345) == int(gl64.exp(np.uint64(a), 12345))
    assert np.array_equal(gl.to_u64(gl.shift_powers(6)),
                          ntt_np.shift_powers(6))
    assert np.array_equal(gl.bit_reverse(5).numpy(),
                          ntt_np._bit_reverse_indices(5))
    pw = gl.powers(a, 37)
    assert np.array_equal(gl.to_u64(pw), gl64.exp_vec(
        np.uint64(a), np.arange(37, dtype=np.uint64)))
    assert torch.equal(gl.full((2,), P - 1, None),
                       torch.tensor([gl.as_i64(P - 1)] * 2))
