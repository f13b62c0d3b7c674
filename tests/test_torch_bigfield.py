"""The port's big-field hash layer (BN128 / BLS12381) against the JAX package.

Poseidon over Fr (ops/poseidon_fr.py: the plain version on the CPU, the
CUDA kernel on the card), the leaf hash, the 16-ary device Merkle tree, its
proof checks and the transcript, each held against eigen_zkvm_tpu's
hash/{poseidon,linearhash,merkle,transcript}_big.py on the same inputs,
made from a numpy seed.  Tolerance 0: field arithmetic is exact.  The tests
marked cuda run the kernel against its plain version and skip without a
card (python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_bigfield.py).
"""
import random

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.hash import linearhash_big as jlh
from eigen_zkvm_tpu.hash import poseidon_bls12381 as jbls
from eigen_zkvm_tpu.hash import poseidon_bn128 as jbn
from eigen_zkvm_tpu.hash.merkle_big import MerkleTreeBLS12381, MerkleTreeBN128
from eigen_zkvm_tpu.hash.transcript_big import (TranscriptBLS12381 as
                                                JTranscriptBLS12381)
from eigen_zkvm_tpu.hash.transcript_big import (TranscriptBN128 as
                                                JTranscriptBN128)
from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.hash import linearhash_big as lh
from eigen_zkvm_tpu_torch.hash import merkle_big, transcript_big
from eigen_zkvm_tpu_torch.hash import poseidon_bls12381, poseidon_bn128
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import commit_big, gl, poseidon_fr
from eigen_zkvm_tpu_torch.stark.backends import get_backend

GL_P = 0xFFFFFFFF00000001
# field name -> (port field, port Poseidon module, JAX Poseidon module,
# JAX tree class, port Merkle checks, port / JAX transcripts)
CURVES = {
    "BN128": (bi.FR, poseidon_bn128, jbn, MerkleTreeBN128,
              merkle_big.MerkleBN128, transcript_big.TranscriptBN128,
              JTranscriptBN128),
    "BLS12381": (bi.FR_BLS, poseidon_bls12381, jbls, MerkleTreeBLS12381,
                 merkle_big.MerkleBLS12381,
                 transcript_big.TranscriptBLS12381, JTranscriptBLS12381),
}


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _states(field: bi.Field, t: int, B: int, seed: int) -> list[list[int]]:
    """B states of t values: random, then all 0, all r - 1, and 0 / r - 1
    alternating."""
    rng = random.Random(seed)
    r = field.modulus
    st = [[rng.randrange(r) for _ in range(t)] for _ in range(B)]
    st[0] = [0] * t
    st[1] = [r - 1] * t
    st[2] = [(r - 1) * (i & 1) for i in range(t)]
    return st


def _split(states, device="cpu"):
    """States -> (inp [B, t-1, 4], init [B, 4]) word tensors."""
    B, t = len(states), len(states[0])
    inp = bi.to_tensor([v for s in states for v in s[1:]], device).view(
        B, t - 1, 4)
    return inp, bi.to_tensor([s[0] for s in states], device)


def _gl_rows(rng, h: int, w: int) -> np.ndarray:
    rows = rng.integers(0, 2**64, size=(h, w), dtype=np.uint64) \
        % np.uint64(GL_P)
    if h > 2 and w:
        rows[0] = 0
        rows[1] = GL_P - 1
    return rows


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("t", range(2, 18))
def test_permute_plain_equals_jax_hash_ex(curve, t):
    """Every width, 0 and r - 1 among the inputs: the plain permutation's
    t lanes (on the CPU, Python ints), the limb arithmetic's (the card's
    plain version) and the port's Python-int hash_ex equal the JAX
    package's hash_ex; a launch-free CPU path."""
    field, port_mod, jax_mod = CURVES[curve][:3]
    states = _states(field, t, 5, t)
    want = [jax_mod.hash_ex(s[1:], s[0], t) for s in states]
    before = kernels.counts()
    got = poseidon_fr.permute(field, t, *_split(states), n_out=t)
    assert kernels.counts() == before
    assert [bi.to_ints(row) for row in got] == want
    got = poseidon_fr.permute_limbs(field, t, *_split(states), n_out=t)
    assert [bi.to_ints(row) for row in got] == want
    assert [port_mod.hash_ex(s[1:], s[0], t) for s in states] == want


GOLDEN = {
    "BN128": [
        ([1], 18586133768512220936620570745912940619677854269274689475585506675881198879027),
        ([1, 2], 7853200120776062878684798364095072458815029376092732009249414926327459813530),
        ([1, 2, 0, 0, 0], 1018317224307729531995786483840663576608797660851238720571059489595066344487),
    ],
    "BLS12381": [
        ([1], 10090463338479474364654416042385169859560025017303585988626920959727361545503),
        ([1, 0], 40315999570263005229566068098191840653718756303362127561954793579940120806360),
        ([1, 2, 0, 0, 0], 25489954628706771422434337159093356230875147553184381182493646336226215511862),
        ([1, 2, 3, 4], 50374862952696036512232585533148559412665642735378685892656796916864806976141),
    ],
}


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_golden_vectors(curve):
    """tests/test_bn128.py and tests/test_bls12381.py's golden hashes, on
    ints and through the tensor path (BLS12381: the second output)."""
    field, port_mod = CURVES[curve][:2]
    for inp, want in GOLDEN[curve]:
        assert port_mod.hash_fr(inp) == want
        got = poseidon_fr.hash_fr(field, bi.to_tensor(inp).view(1, -1, 4))
        assert bi.to_ints(got) == [want]


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("w", [0, 1, 3, 4, 5, 12, 48, 49, 375])
def test_hash_leaves_equals_jax(curve, w):
    """The tensor leaf hash row for row against the JAX package's batch
    leaf hash (w > 4) and its one-row hash_element_array (every w); the
    port's host hash_element_array too."""
    field, port_mod, jax_mod = CURVES[curve][:3]
    rng = np.random.default_rng(w)
    rows = _gl_rows(rng, 6, w)
    got = bi.to_ints(lh.hash_leaves(field, gl.from_u64(rows)))
    want = [jlh.hash_element_array(jax_mod, r) for r in rows]
    assert got == want
    assert [lh.hash_element_array(port_mod.POSEIDON, r) for r in rows] == want
    if w > 4:
        batch = jlh.hash_leaves_batch_limbs(jax_mod, rows)
        if batch is not None:  # the JAX package's native kernel loaded
            assert got == [int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128
                           | int(r[3]) << 192 for r in batch]


def test_wide_values_pack_mod_r():
    """A row of width 4 whose packed value is above r: the port reduces it
    as the JAX package does."""
    rows = np.full((2, 4), GL_P - 1, dtype=np.uint64)
    for curve in CURVES:
        field, _, jax_mod = CURVES[curve][:3]
        got = bi.to_ints(lh.hash_leaves(field, gl.from_u64(rows)))
        assert got == [jlh.hash_element_array(jax_mod, r) for r in rows]
        assert got[0] == sum((GL_P - 1) << (64 * i) for i in range(4)) \
            % field.modulus


@pytest.mark.parametrize("height", [1, 15, 16, 17, 256, 4097])
def test_device_tree_equals_jax_tree(height):
    """Root, levels and group proofs of the device tree (BN128) equal
    MerkleTreeBN128's, and the port's check accepts its proofs."""
    w = 5 if height <= 256 else 3
    rows = _gl_rows(np.random.default_rng(height), height, w)
    tree = commit_big.BN128.merkelize(gl.from_u64(rows))
    host = MerkleTreeBN128().merkelize(rows, w, height)
    assert tree.root() == host.root()
    assert tree.levels() == host.levels
    idxs = sorted({0, 1 % height, height // 2, height - 1})
    tree.prefetch(idxs)
    for idx in idxs:
        v, mp = tree.get_group_proof(idx)
        hv, hmp = host.get_group_proof(idx)
        assert np.array_equal(v, hv) and mp == hmp
        assert merkle_big.MerkleBN128.verify_group_proof(tree.root(), mp, idx,
                                                         v)


def test_bls_tree_and_zero_width_tree_equal_jax():
    """A BLS12381 tree, and the width-0 trees (the full tree over zero
    digests) of both fields, equal the JAX package's."""
    rows = _gl_rows(np.random.default_rng(7), 300, 12)
    tree = commit_big.BLS12381.merkelize(gl.from_u64(rows))
    host = MerkleTreeBLS12381().merkelize(rows, 12, 300)
    assert tree.levels() == host.levels
    assert tree.get_group_proof(299)[1] == host.get_group_proof(299)[1]
    for builder, cls in ((commit_big.BN128, MerkleTreeBN128),
                         (commit_big.BLS12381, MerkleTreeBLS12381)):
        zero = builder.extend_and_merkelize(
            torch.zeros((32, 0), dtype=torch.int64), 5, 6)
        want = cls().merkelize(np.zeros((64, 0), dtype=np.uint64), 0, 64)
        assert zero.root() == want.root() and zero.levels() == want.levels
        v, mp = zero.get_group_proof(5)
        assert v.shape == (0,) and mp == want.get_group_proof(5)[1]


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("w", [0, 1, 3, 4, 5, 12, 49])
def test_verify_group_proof_gives_the_jax_answer(curve, w):
    """Over 64 random rows: the port's check of the JAX tree's proofs gives
    the JAX check's answer at every width (width 4 False in both: the
    prover packs four values where the verifier hashes 3 + 1), and a
    tampered row is rejected by both."""
    _, _, _, jtree, port_merkle = CURVES[curve][:5]
    rows = _gl_rows(np.random.default_rng(64 + w), 64, w)
    host = jtree().merkelize(rows, w, 64)
    for idx in (0, 17, 63):
        v, mp = host.get_group_proof(idx)
        want = jtree.verify_group_proof(host.root(), mp, idx, v)
        assert want == (w != 4)
        assert port_merkle.verify_group_proof(host.root(), mp, idx, v) \
            == want
        if w:
            bad = v.copy()
            bad[0] = (int(bad[0]) + 1) % GL_P
            assert not jtree.verify_group_proof(host.root(), mp, idx, bad)
            assert not port_merkle.verify_group_proof(host.root(), mp, idx,
                                                      bad)


@pytest.mark.parametrize("curve", sorted(CURVES))
def test_transcript_sequences_equal_jax(curve):
    port_cls, jax_cls = CURVES[curve][5:]
    a, b = port_cls(), jax_cls()
    rng = random.Random(11)
    got, want = [], []
    for step in range(12):
        vals = [rng.randrange(GL_P) for _ in range(rng.randrange(0, 21))]
        root = rng.randrange(CURVES[curve][0].modulus)
        for tr in (a, b):
            tr.put_elements(vals)
            tr.put_root(root)
        for _ in range(step % 4 + 1):
            got.append(tuple(int(x) for x in a.get_field()))
            want.append(tuple(int(x) for x in b.get_field()))
        if step % 3 == 2:
            got.append(a.get_permutations(8 + step, 17))
            want.append(b.get_permutations(8 + step, 17))
    assert got == want


def test_backends_dispatch_as_the_jax_package():
    assert get_backend("BN128").tree is commit_big.BN128
    assert get_backend("BLS12381").transcript is \
        transcript_big.TranscriptBLS12381
    with pytest.raises(NotImplementedError):
        get_backend("BN254")


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_poseidon_fr_kernel_matches_plain(cuda, curve):
    """The kernel at every width and output count, on every group size the
    width allows and on `plan`'s pick (so every instance), from one state
    to more than one block holds (B = 300 > 128 groups of one thread),
    against the plain version on the card, bit for bit, then a tree level
    and a wide leaf row against the JAX package's host hash."""
    field, _, jax_mod = CURVES[curve][:3]
    for t in range(2, 18):
        for B in (1, 37, 300):
            states = _states(field, t, B, 100 * B + t) if B > 3 else \
                _states(field, t, 3, t)[:B]
            inp, init = _split(states, cuda)
            want = poseidon_fr.permute_plain(field, t, inp, init, t)
            for lanes in poseidon_fr.lane_choices(t) + (None,):
                before = kernels.POSEIDON_FR.launches
                got = poseidon_fr.permute(field, t, inp, init, t, lanes)
                assert kernels.POSEIDON_FR.launches == before + 1
                assert torch.equal(got, want), (t, B, lanes)
                one = poseidon_fr.permute(field, t, inp, init, 1, lanes)
                assert torch.equal(one, want[:, :1]), (t, B, lanes)
            assert bi.to_ints(got[B - 1]) == jax_mod.hash_ex(
                states[B - 1][1:], states[B - 1][0], t)
    rows = _gl_rows(np.random.default_rng(1), 300, 375)
    got = lh.hash_leaves(field, gl.from_u64(rows, cuda))
    assert torch.equal(got.cpu(), lh.hash_leaves(field, gl.from_u64(rows)))
    assert bi.to_ints(got[:4]) == [jlh.hash_element_array(jax_mod, r)
                                   for r in rows[:4]]


@pytest.mark.cuda
def test_device_tree_on_the_card_equals_jax_tree(cuda):
    rows = _gl_rows(np.random.default_rng(5), 4097, 12)
    tree = commit_big.BN128.merkelize(gl.from_u64(rows, cuda))
    host = MerkleTreeBN128().merkelize(rows, 12, 4097)
    assert tree.levels() == host.levels
    v, mp = tree.get_group_proof(4096)
    hv, hmp = host.get_group_proof(4096)
    assert np.array_equal(v, hv) and mp == hmp


def test_permute_rejects_what_it_does_not_take():
    inp = torch.zeros((2, 3, 4), dtype=torch.int64)
    init = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        poseidon_fr.permute(bi.FR, 5, inp, init)
    with pytest.raises(ValueError):
        poseidon_fr.permute(bi.FR, 4, inp, init, n_out=5)
    with pytest.raises(ValueError):
        poseidon_fr.permute(bi.FR, 4, inp.float(), init)
