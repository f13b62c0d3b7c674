"""The port's BN254 field arithmetic (eigen_zkvm_tpu_torch/ops/bigint.py, the
plain versions of csrc/bn254.cuh) against Python ints and against the JAX
package's ops/bigint_jax.py on the CPU.  Exact: these are field elements."""
import random

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.ops import bigint_jax
from eigen_zkvm_tpu_torch.kernels import bn254_check
from eigen_zkvm_tpu_torch.ops import bigint as bi


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m: int):
    """tests/test_ec_jax.py's operands, with R mod m added."""
    rng = random.Random(11)
    xs = [rng.randrange(m) for _ in range(64)] + [0, 1, m - 1, m - 2,
                                                  (1 << 256) % m]
    ys = [rng.randrange(m) for _ in range(64)] + [m - 1, 0, m - 1, 1,
                                                  (1 << 256) % m]
    return xs, ys


@pytest.mark.parametrize("field", [bi.FQ, bi.FR], ids=["Fq", "Fr"])
def test_field_ops_match_python_ints(field):
    m = field.modulus
    xs, ys = _operands(m)
    a, b = bi.to_tensor(xs), bi.to_tensor(ys)
    assert bi.to_ints(a) == xs
    assert bi.to_ints(bi.add_w(field, a, b)) == [(x + y) % m
                                                  for x, y in zip(xs, ys)]
    assert bi.to_ints(bi.sub_w(field, a, b)) == [(x - y) % m
                                                  for x, y in zip(xs, ys)]
    am, bm = bi.to_mont(field, a), bi.to_mont(field, b)
    assert bi.to_ints(am) == [(x << 256) % m for x in xs]
    assert torch.equal(am, bi.mont_ints(field, xs))
    prod = bi.from_mont(field, bi.mul_w(field, am, bm))
    assert bi.to_ints(prod) == [x * y % m for x, y in zip(xs, ys)]
    sq = bi.from_mont(field, bi.sqr_w(field, am))
    assert bi.to_ints(sq) == [x * x % m for x in xs]
    inv = bi.from_mont(field, bi.inv_w(field, am[-8:]))
    assert bi.to_ints(inv) == [pow(x, m - 2, m) for x in xs[-8:]]


def test_fq_matches_bigint_jax():
    """The same Montgomery words as bigint_jax (R = 2^256 in both)."""
    import jax.numpy as jnp

    xs, ys = _operands(bigint_jax.P_INT)
    ja, jb = jnp.asarray(bigint_jax.pack(xs)), jnp.asarray(bigint_jax.pack(ys))
    jam, jbm = bigint_jax.to_mont(ja), bigint_jax.to_mont(jb)
    a, b = bi.to_tensor(xs), bi.to_tensor(ys)
    am, bm = bi.to_mont(bi.FQ, a), bi.to_mont(bi.FQ, b)
    assert bi.to_ints(am) == bigint_jax.unpack(jam)
    assert bi.to_ints(bi.mul_w(bi.FQ, am, bm)) == \
        bigint_jax.unpack(bigint_jax.mont_mul(jam, jbm))
    assert bi.to_ints(bi.add_w(bi.FQ, a, b)) == \
        bigint_jax.unpack(bigint_jax.add(ja, jb))
    assert bi.to_ints(bi.sub_w(bi.FQ, a, b)) == \
        bigint_jax.unpack(bigint_jax.sub(ja, jb))
    assert bi.to_ints(bi.from_mont(bi.FQ, am)) == \
        bigint_jax.unpack(bigint_jax.from_mont(jam))


def test_fq2_ops_match_the_curve_module():
    rng = random.Random(5)
    P = jbn.P
    xs = [(rng.randrange(P), rng.randrange(P)) for _ in range(20)] + \
        [(0, 1), (1, 0), (P - 1, P - 1)]
    ys = [(rng.randrange(P), rng.randrange(P)) for _ in range(23)]

    def mont(v):
        return bi.mont_ints(bi.FQ, [c for p in v for c in p]).view(-1, 2, 4)

    def ints(t):
        v = [bi.FQ.from_mont_int(x) for x in bi.to_ints(t)]
        return list(zip(v[::2], v[1::2]))

    assert ints(bi.f2_mul_w(bi.FQ, mont(xs), mont(ys))) == \
        [jbn.f2_mul(x, y) for x, y in zip(xs, ys)]
    assert ints(bi.f2_inv_w(bi.FQ, mont(xs))) == [jbn.f2_inv(x) for x in xs]


@pytest.mark.parametrize("field", [bi.FQ, bi.FR], ids=["Fq", "Fr"])
def test_batch_inverse(field):
    m = field.modulus
    rng = random.Random(2)
    xs = [rng.randrange(1, m) for _ in range(37)] + [1, m - 1]
    got = bi.batch_inv(field, bi.limbs(bi.mont_ints(field, xs)))
    assert bi.to_ints(bi.from_mont(field, bi.words(got))) == \
        [pow(x, m - 2, m) for x in xs]


def test_words_limbs_roundtrip_and_int64_layout():
    vals = [0, 1, (1 << 256) - 1, 1 << 63, (1 << 64) - 1, bi.P_INT]
    t = bi.to_tensor(vals)
    assert t.dtype == torch.int64 and t.shape == (6, 4)
    assert torch.equal(bi.words(bi.limbs(t)), t)
    raw = t.numpy().view(np.uint64)
    assert [sum(int(w) << (64 * i) for i, w in enumerate(row))
            for row in raw] == vals


@pytest.mark.parametrize("op", sorted(bn254_check.OPS))
def test_device_check_expectations_agree_with_plain_ops(op):
    """kernels/bn254_check.py's expected values (Python ints, the raw-word
    semantics the CUDA test entry has) equal the plain tensor ops, so the
    card's check holds the kernels to the same function."""
    field = bi.FQ
    a, b = bn254_check.operands(op, field, 24, seed=3)
    want = bn254_check.expected(op, field, a, b)
    if op.startswith("f2_"):
        ta = bi.to_tensor([c for p in a for c in p]).view(-1, 2, 4)
        tb = bi.to_tensor([c for p in b for c in p]).view(-1, 2, 4)
        fn = {"f2_mul": lambda: bi.f2_mul_w(field, ta, tb),
              "f2_sqr": lambda: bi.f2_mul_w(field, ta, ta),
              "f2_inv": lambda: bi.words(bi.f2_inv(bi.limbs(ta)))}[op]
        v = bi.to_ints(fn())
        got = list(zip(v[::2], v[1::2]))
    else:
        ta, tb = bi.to_tensor(a), bi.to_tensor(b)
        fn = {"mul": lambda: bi.mul_w(field, ta, tb),
              "sqr": lambda: bi.sqr_w(field, ta),
              "add": lambda: bi.add_w(field, ta, tb),
              "sub": lambda: bi.sub_w(field, ta, tb),
              "neg": lambda: bi.words(bi.neg(field, bi.limbs(ta))),
              "inv": lambda: bi.inv_w(field, ta)}[op]
        got = bi.to_ints(fn())
    assert got == want
