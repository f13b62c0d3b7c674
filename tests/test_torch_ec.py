"""The port's batched BN254 G1/G2 arithmetic (eigen_zkvm_tpu_torch/ops/ec.py,
the plain versions of csrc/msm.cu and csrc/ec_batch.cu) against the JAX
package's curves on the CPU: the MSM on tests/test_ec_jax.py's edge cases
(infinity, a duplicated point, scalars 0, 1 and r - 1) and on
tests/test_native_ec.py's hot buckets, the fixed-base batch against the
Python scalar multiply.  Exact: these are group elements."""
import random

import pytest
import torch

from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.curves.msm import msm_g1, msm_g2
from eigen_zkvm_tpu_torch.ops import bigint as bi
from eigen_zkvm_tpu_torch.ops import ec

R = jbn.R


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g1_points(rng, n):
    g = jbn.g1_from_affine(jbn.G1_GEN)
    return [jbn.g1_to_affine(jbn.g1_mul(g, rng.randrange(1, R)))
            for _ in range(n)]


def _msm(g, pts, scalars):
    return ec.affine_ints(g, ec.msm(g, ec.affine_tensor(g, pts),
                                    bi.to_tensor(scalars)))[0]


@pytest.fixture(scope="module")
def ec_jax_case():
    return _ec_jax_inputs()


def _ec_jax_inputs():
    """tests/test_ec_jax.py::test_msm_differential's inputs."""
    rng = random.Random(7)
    pts = _g1_points(rng, 33)
    pts[3] = None            # infinity input
    pts[7] = pts[5]          # duplicate point (exercises doubling case)
    scalars = [rng.randrange(0, R) for _ in range(33)]
    scalars[11] = 0
    scalars[12] = 1
    scalars[13] = R - 1
    return pts, scalars


def test_g1_msm_edge_cases_match_msm_g1(ec_jax_case):
    pts, scalars = ec_jax_case
    assert _msm(ec.G1, pts, scalars) == msm_g1(jbn, pts, scalars)
    assert _msm(ec.G1, pts[:4], [0, 0, 0, 0]) is None


def test_double_and_add_reference_matches_msm_g1(ec_jax_case):
    """msm_plain, the reference the MSM kernel is held against on the card
    (ec_jax's double-and-add and tree reduce), on the edge cases: an odd
    batch, infinity, a duplicate, scalars 0, 1 and r - 1.  (Its G2 case
    runs on the card: tests/test_torch_kernels.py.)"""
    pts, scalars = ec_jax_case
    got = ec.msm_plain(ec.G1, ec.affine_tensor(ec.G1, pts),
                       bi.to_tensor(scalars))
    assert ec.affine_ints(ec.G1, got)[0] == msm_g1(jbn, pts, scalars)


@pytest.mark.parametrize("case", ["hot", "tiny", "doubling"])
def test_g1_msm_hot_buckets_match_msm_g1(case):
    """tests/test_native_ec.py's degenerate inputs: a hot bucket of
    repeated scalar 1, tiny scalars, the same scalar on repeated points."""
    rng = random.Random(13)
    pts = _g1_points(rng, 48)
    pts[7] = None
    pts[11] = pts[10]
    pts[12] = pts[10]
    scalars = {"hot": [1] * 30 + [rng.randrange(R) for _ in range(18)],
               "tiny": [rng.randrange(4) for _ in range(48)],
               "doubling": [R - 1] * 20 + [2] * 28}[case]
    assert _msm(ec.G1, pts, scalars) == msm_g1(jbn, pts, scalars)


def test_g2_msm_matches_msm_g2():
    rng = random.Random(23)
    base = jbn.g2_from_affine(jbn.G2_GEN)
    pts = [jbn.g2_to_affine(jbn.g2_mul(base, rng.randrange(1, R)))
           for _ in range(24)]
    pts[4] = None
    pts[9] = pts[8]
    scalars = [1] * 10 + [rng.randrange(R) for _ in range(12)] + [0, R - 1]
    assert _msm(ec.G2, pts, scalars) == msm_g2(jbn, pts, scalars)


@pytest.mark.parametrize("g", [ec.G1, ec.G2], ids=["G1", "G2"])
def test_fixed_base_batch_matches_scalar_multiply(g):
    rng = random.Random(17)
    scalars = [0, 1, 2, R - 1, R // 2] + [rng.randrange(R) for _ in range(11)]
    got = ec.affine_ints(g, ec.scalar_mul_batch(g, ec.generator(g),
                                                bi.to_tensor(scalars)))
    if g is ec.G1:
        gen = jbn.g1_from_affine(jbn.G1_GEN)
        want = [jbn.g1_to_affine(jbn.g1_mul(gen, s)) for s in scalars]
    else:
        gen = jbn.g2_from_affine(jbn.G2_GEN)
        want = [jbn.g2_to_affine(jbn.g2_mul(gen, s)) for s in scalars]
    assert got == want


def test_segment_sums_and_digits():
    """The MSM's glue: c-bit digits recombine to the scalar, segments cut
    runs of one key every SEGMENT entries, and segment sums equal the
    Python sums."""
    rng = random.Random(3)
    scalars = [0, 1, R - 1] + [rng.randrange(R) for _ in range(9)]
    for c in (4, 9, 14):
        d = ec.digits(bi.to_tensor(scalars), c).tolist()
        assert [sum(v << (c * w) for w, v in enumerate(row))
                for row in d] == scalars
    keys = torch.tensor([3] * 70 + [5] + [9] * 2)
    start, seg_keys = ec.segments(keys)
    assert start.tolist() == [0, 32, 64, 70, 71, 73]
    assert seg_keys.tolist() == [3, 3, 3, 5, 9]
    pts = _g1_points(rng, 5)
    idx = torch.tensor([0, 1, 2, 2, 3, 4, 0])
    start = torch.tensor([0, 4, 5, 7])
    out = ec.sums_plain(ec.G1, ec.affine_tensor(ec.G1, pts), True, idx, start)
    got = ec.affine_ints(ec.G1, ec.to_affine(ec.G1, ec.from_jacobian(out)))

    def py_sum(ix):
        acc = jbn.G1_ZERO
        for i in ix:
            acc = jbn.g1_add(acc, jbn.g1_from_affine(pts[i]))
        return jbn.g1_to_affine(acc)

    assert got == [py_sum([0, 1, 2, 2]), py_sum([3]), py_sum([4, 0])]


def test_plain_batches_cut_into_chunks_give_the_same_points(monkeypatch):
    """sums_plain and the plain fixed-base batch cut their work into batches
    of PLAIN_CHUNK entries or lanes (the card's sizes); with a tiny chunk the
    segment sums and lanes come out as with one batch, and
    msm_stages_plain, which the kernel is held against at the prove's
    sizes, equals msm_g1 on the edge cases."""
    rng = random.Random(5)
    pts = ec.affine_tensor(ec.G1, _g1_points(rng, 6))
    idx = torch.tensor([0, 1, 2, 2, 3, 4, 0, 5, 5, 1, 3])
    start = torch.tensor([0, 4, 5, 7, 9, 11])
    scalars = bi.to_tensor([0, 1, R - 1] + [rng.randrange(R) for _ in range(4)])
    whole = ec.sums_plain(ec.G1, pts, True, idx, start)
    lanes = ec.scalar_mul_batch_plain(ec.G1, ec.generator(ec.G1), scalars)
    edge_pts, edge_scalars = _ec_jax_inputs()
    got = ec.msm_stages_plain(ec.G1, ec.affine_tensor(ec.G1, edge_pts),
                              bi.to_tensor(edge_scalars))
    assert ec.affine_ints(ec.G1, got)[0] == msm_g1(jbn, edge_pts, edge_scalars)
    monkeypatch.setattr(ec, "PLAIN_CHUNK", 3)
    assert torch.equal(ec.sums_plain(ec.G1, pts, True, idx, start), whole)
    assert torch.equal(ec.scalar_mul_batch_plain(
        ec.G1, ec.generator(ec.G1), scalars), lanes)


def test_msm_refuses_wrong_shapes():
    """msm checks its shapes before it dispatches."""
    with pytest.raises(ValueError):
        ec.msm(ec.G1, torch.zeros((3, 2, 4), dtype=torch.int64),
               torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ec.msm(ec.G2, torch.zeros((3, 2, 4), dtype=torch.int64),
               torch.zeros((3, 4), dtype=torch.int64))


@pytest.mark.slow
def test_g1_msm_matches_ec_jax(ec_jax_case):
    from eigen_zkvm_tpu.ops import ec_jax

    pts, scalars = ec_jax_case
    assert _msm(ec.G1, pts, scalars) == ec_jax.msm(pts, scalars)
