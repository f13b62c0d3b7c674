"""The big-field Poseidon kernel's launch plan, and the 16-ary trees whose
leaf digests are all equal, against the JAX package.

`ops/poseidon_fr.plan` picks the threads a permutation (its group size)
and the block size from the width and the batch; its rule is held here on
the CPU.  `ops/commit_big.build_nodes` hashes only the first and the last
group of each level of a tree whose leaf digests are equal (a width-0
section, equal rows of width <= 4): the root, levels and group proofs
must equal eigen_zkvm_tpu's MerkleTreeBN128 / MerkleTreeBLS12381 on the
same rows, at heights whose levels end in a partial group, for at most two
permutations a level.  Tolerance 0: field arithmetic is exact.  The test
marked cuda counts the kernel's launches on the card and skips without one
(python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_fr_trees.py).
"""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.hash.merkle_big import MerkleTreeBLS12381, MerkleTreeBN128
from eigen_zkvm_tpu_torch import kernels
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import commit_big, gl, poseidon_fr

GL_P = 0xFFFFFFFF00000001
TREES = {"BN128": (commit_big.BN128, MerkleTreeBN128),
         "BLS12381": (commit_big.BLS12381, MerkleTreeBLS12381)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain permutation is many small tensor operations: one torch
    thread, so the test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def permutations(monkeypatch):
    """The batch of every permute call made while the test runs."""
    calls = []
    orig = poseidon_fr.permute

    def counted(field, t, inp, init, n_out=1, **kw):
        calls.append(inp.shape[0])
        return orig(field, t, inp, init, n_out, **kw)

    monkeypatch.setattr(poseidon_fr, "permute", counted)
    return calls


def _n_p(t: int) -> int:
    return poseidon_fr.poseidon(bi.FR).n_rounds_p(t)


@pytest.mark.parametrize("t", range(2, 18))
def test_lane_choices_fit_the_kernel_instances(t):
    """Every group size a width may take: one thread (the one-thread
    kernel, any width), or a power of two up to 32 with each thread owning
    at most MAX_OWNED lanes and no group twice the state."""
    choices = poseidon_fr.lane_choices(t)
    assert choices[0] == 1 and set(choices) <= set(poseidon_fr.LANES)
    for g in choices[1:]:
        assert -(-t // g) <= poseidon_fr.MAX_OWNED and g < 2 * t
    assert len(choices) > 1
    chains = [poseidon_fr.chain_products(t, _n_p(t), g) for g in choices]
    assert chains == sorted(chains, reverse=True)  # wider: shorter chain


@pytest.mark.parametrize("t", range(2, 18))
def test_plan_fills_the_card_then_shortens_the_chain(t):
    """The rule of `plan`: a batch that fills the card takes the smallest
    group (the leaves: one thread a permutation where the width allows), a
    lone permutation the widest (the shortest chain); the pick never
    widens as the batch grows; it is the least of chain x max(LATENCY,
    warps a scheduler); blocks shrink to 64 or 32 threads only where 128
    would leave SMs without a block."""
    n_p, sms = _n_p(t), 132
    choices = poseidon_fr.lane_choices(t)
    slots = sms * poseidon_fr.SCHEDULERS_PER_SM
    assert poseidon_fr.plan(t, n_p, 1 << 24, sms)[0] == choices[0]
    assert poseidon_fr.plan(t, n_p, 1, sms) == (choices[-1], 32)
    last = choices[-1]
    for B in [1, 2, 3, 16, 31, 32, 33, 512, 1000, 4096, 8192, 16384, 65536,
              1 << 17, 1 << 21]:
        g, threads = poseidon_fr.plan(t, n_p, B, sms)
        assert g in choices and g <= last
        last = g

        def cost(h):
            return poseidon_fr.chain_products(t, n_p, h) * max(
                poseidon_fr.LATENCY, -(-B * h // 32) / slots)

        assert cost(g) == min(cost(h) for h in choices)
        assert threads == poseidon_fr.plan_threads(B, g, sms)
        total = 32 * -(-B * g // 32)
        if threads == 128:
            assert -(-total // 128) >= sms
        else:
            assert threads in (32, 64) and -(-total // (2 * threads)) < sms
            assert threads == 32 or -(-total // threads) >= sms


def test_plan_at_the_shapes_of_a_prove():
    """The picks the big-field prove runs: its leaves (t = 5 at 2^17) and
    a 2^14 sponge of 375-wide rows one thread a permutation, a 2^13-node
    level groups of 4, the top levels a warp a permutation."""
    assert poseidon_fr.plan(5, _n_p(5), 1 << 17) == (1, 128)
    assert poseidon_fr.plan(17, _n_p(17), 1 << 13) == (4, 128)
    assert poseidon_fr.plan(17, _n_p(17), 1 << 14) == (1, 64)
    assert poseidon_fr.plan(17, _n_p(17), 512) == (32, 64)
    assert poseidon_fr.plan(17, _n_p(17), 2) == (32, 32)


def test_permute_rejects_a_group_size_the_kernel_lacks():
    inp = torch.zeros((2, 16, 4), dtype=torch.int64)
    init = torch.zeros((2, 4), dtype=torch.int64)
    for g in (2, 3, 64):
        with pytest.raises(ValueError):
            poseidon_fr.permute(bi.FR, 17, inp, init, lanes=g)
    # on the CPU every allowed group size is the plain version
    want = poseidon_fr.permute(bi.FR, 17, inp, init, n_out=2)
    assert torch.equal(poseidon_fr.permute(bi.FR, 17, inp, init, 2, lanes=8),
                       want)


def _check_tree(curve: str, rows: np.ndarray, calls: list):
    backend, jtree = TREES[curve]
    height, width = rows.shape
    tree = backend.merkelize(gl.from_u64(rows))
    host = jtree().merkelize(rows, width, height)
    assert tree.root() == host.root()
    assert tree.levels() == host.levels
    idxs = sorted({0, height // 2, height - 1})
    tree.prefetch(idxs)
    for idx in idxs:
        v, mp = tree.get_group_proof(idx)
        hv, hmp = host.get_group_proof(idx)
        assert np.array_equal(v, hv) and mp == hmp
    return len(host.levels) - 1


@pytest.mark.parametrize("curve", sorted(TREES))
@pytest.mark.parametrize("height", [1, 17, 4097, (1 << 17) + 1])
def test_width_zero_tree_costs_two_permutations_a_level(curve, height,
                                                        permutations):
    """A width-0 section's tree over zero digests: one permute call a
    level, of at most two states, and the JAX package's tree."""
    rows = np.zeros((height, 0), dtype=np.uint64)
    levels = _check_tree(curve, rows, permutations)
    assert len(permutations) == levels
    assert all(b <= 2 for b in permutations)


@pytest.mark.parametrize("curve", sorted(TREES))
@pytest.mark.parametrize("width, height", [(1, 33), (3, 4097), (4, 300)])
def test_equal_narrow_rows_cost_two_permutations_a_level(curve, width,
                                                         height,
                                                         permutations):
    """Rows of width <= 4 pack with no permutation: all-zero rows, and
    equal non-zero rows (their packed value reduced mod r at width 4),
    give equal digests and the same two permutations a level."""
    rows = np.zeros((height, width), dtype=np.uint64)
    levels = _check_tree(curve, rows, permutations)
    assert len(permutations) == levels and max(permutations) <= 2
    permutations.clear()
    rows[:] = GL_P - 1 - np.arange(width, dtype=np.uint64)
    levels = _check_tree(curve, rows, permutations)
    assert len(permutations) == levels and max(permutations) <= 2


@pytest.mark.parametrize("curve", sorted(TREES))
def test_equal_wide_rows_are_not_compared(curve, permutations):
    """Rows wider than 4 pass through a permutation, so their digests are
    not compared: equal rows of width 5 hash every group of every level
    (33 rows: the leaves, 3 groups, 1), and the tree is the JAX
    package's."""
    rows = np.zeros((33, 5), dtype=np.uint64)
    _check_tree(curve, rows, permutations)
    assert permutations == [33, 3, 1]


def test_unequal_rows_hash_every_group(permutations):
    """One row that differs: no shortcut, every group of every level."""
    rows = np.full((4097, 2), 5, dtype=np.uint64)
    rows[-1, 1] = 6
    levels = _check_tree("BN128", rows, permutations)
    assert permutations == [257, 17, 2, 1][:levels]


@pytest.mark.cuda
def test_equal_leaf_tree_on_the_card_launches_once_a_level(cuda):
    """On the card: a width-0 tree of 2^17 + 1 rows equals the JAX
    package's, one kernel launch a level."""
    height = (1 << 17) + 1
    before = kernels.POSEIDON_FR.launches
    tree = commit_big.BN128.merkelize(
        torch.zeros((height, 0), dtype=torch.int64, device=cuda))
    host = MerkleTreeBN128().merkelize(np.zeros((height, 0), np.uint64), 0,
                                       height)
    assert kernels.POSEIDON_FR.launches - before == len(host.levels) - 1
    assert tree.root() == host.root() and tree.levels() == host.levels
