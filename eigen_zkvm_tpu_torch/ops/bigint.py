"""The prime fields of BN254 (Fq, Fr) and of BLS12-381 (Fq381, Fr381) on
int64 tensors: the plain versions of the device arithmetic in
csrc/bn254.cuh.

Port of eigen_zkvm_tpu/ops/bigint_jax.py, with the word count a property
of the field: BN254's two fields and BLS12-381's scalar field (FR_BLS,
below 2^255; also the big-field Poseidon's, ops/poseidon_fr.py) take four
u64 words, BLS12-381's base field (FQ381, below 2^381) six.  An element is
stored as [..., W] int64: W u64 words, little-endian, the layout the CUDA
kernels read and write.  Field elements are kept in Montgomery form (R =
2^(64 W): 2^256 or 2^384); an Fq2 element a0 + a1*u is [..., 2, W] (u^2 =
-1 on both curves).  Scalars that leave Montgomery form (MSM scalars, the
witness) use four words.

Arithmetic unpacks the words into 2 W 32-bit limbs held in int64
([..., 2 W]), as bigint_jax does with 16-bit limbs in u32.  torch has no
unsigned 64-bit arithmetic on the CPU, so a limb product, below 2^64, wraps
in int64 to its exact bit pattern (as ops/gl.py's are) and is split into
32-bit halves with masked shifts; a column of a schoolbook product sums at
most 24 halves, far below 2^63.  Carries are resolved in O(1) tensor
operations by packing the limbs' generate and propagate bits into one
integer per element and letting an integer add run the chain
(bigint_jax._ks).

Montgomery multiplication is SOS by the full inverse, as in
bigint_jax.mont_mul: t = a*b, m = (t mod R) * (-q^-1) mod R,
(t + m*q) / R, one conditional subtraction (every modulus is below R / 2,
so twice it fits the limbs).  Every result is canonical.

Python ints cross with `to_tensor` / `to_ints` through `int.to_bytes` and
numpy, which keeps 10^7 values to seconds.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

NLIMB = 8
LIMB_BITS = 32
MASK = 0xFFFFFFFF
P_INT = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R_INT = 21888242871839275222246405745257275088548364400416034343698204186575808495617
R_BLS_INT = 52435875175126190479447740508185965837690552500527637822603658699938581184513
P_BLS_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB


class Field:
    """A prime field of `words` u64 words and its Montgomery constants (R =
    2^(64 words)).  The modulus is below R / 2: twice it fits the limbs, so
    the sum of two canonical values does and one conditional subtraction
    reduces it."""

    def __init__(self, name: str, modulus: int, words: int = 4):
        if 2 * modulus >= 1 << (64 * words):
            raise ValueError(f"{name}: twice the modulus must fit "
                             f"{words} words")
        self.name = name
        self.modulus = modulus
        self.words = words
        self.nlimb = 2 * words
        self.rbits = 64 * words
        R = 1 << self.rbits
        self.nprime = (-pow(modulus, -1, R)) % R
        self.one = R % modulus                   # 1 in Montgomery form
        self.r2 = R * R % modulus

    def __repr__(self) -> str:
        return self.name

    def to_mont_int(self, x: int) -> int:
        return (x << self.rbits) % self.modulus

    def from_mont_int(self, x: int) -> int:
        return x * pow(1 << self.rbits, -1, self.modulus) % self.modulus


FQ = Field("Fq", P_INT)
FR = Field("Fr", R_INT)
FR_BLS = Field("Fr381", R_BLS_INT)
FQ381 = Field("Fq381", P_BLS_INT, words=6)


# ---- Python ints <-> word tensors ----

def to_tensor(values, device: torch.device | str | None = None,
              words: int = 4) -> torch.Tensor:
    """Ints in [0, 2^(64 words)) -> [n, words] int64 words."""
    nb = 8 * words
    blob = b"".join(int(v).to_bytes(nb, "little") for v in values)
    arr = np.frombuffer(blob, dtype="<u8").reshape(-1, words).view(np.int64)
    t = torch.from_numpy(arr.copy())
    return t if device is None else t.to(device)


def to_ints(t: torch.Tensor) -> list[int]:
    """[..., W] int64 words -> flat list of ints, one per W words."""
    nb = 8 * t.shape[-1]
    b = t.detach().cpu().contiguous().numpy().astype("<i8").tobytes()
    return [int.from_bytes(b[i : i + nb], "little")
            for i in range(0, len(b), nb)]


def mont_ints(field: Field, values, device=None) -> torch.Tensor:
    """Ints (any, reduced mod the field) -> [n, W] words in Montgomery
    form."""
    m = field.modulus
    return to_tensor([(int(v) % m << field.rbits) % m for v in values],
                     device, field.words)


# ---- words <-> limbs ----

@functools.lru_cache(maxsize=None)
def _arange(n: int, step: int, device: torch.device) -> torch.Tensor:
    return torch.arange(0, n * step, step, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def const(value: int, device: torch.device, n: int = NLIMB) -> torch.Tensor:
    """The n 32-bit limbs of an int below 2^(32n), a [n] tensor on
    `device`."""
    return torch.tensor([(value >> (LIMB_BITS * i)) & MASK for i in range(n)],
                        dtype=torch.int64, device=device)


def limbs(w: torch.Tensor) -> torch.Tensor:
    """[..., W] words -> [..., 2 W] 32-bit limbs."""
    sh = _arange(2, LIMB_BITS, w.device)
    return ((w.unsqueeze(-1) >> sh) & MASK).flatten(-2)


def words(x: torch.Tensor) -> torch.Tensor:
    """[..., 2 W] canonical limbs -> [..., W] words."""
    sh = _arange(2, LIMB_BITS, x.device)
    return (x.unflatten(-1, (-1, 2)) << sh).sum(-1)


# ---- carries ----

@functools.lru_cache(maxsize=None)
def _bit_weights(n: int, device: torch.device) -> torch.Tensor:
    return 1 << _arange(n, 1, device)


def _carry_mask(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bit i set where a carry enters limb i of a chain whose limb i
    generates a carry where g and passes one on where p (never both); bit n
    is the carry out of the top.  O(1) operations: with the bits packed
    into integers G and P and X = G | P, the carries are the bits that
    X + G flips (bigint_jax._ks).  At most 62 limbs."""
    pw = _bit_weights(g.shape[-1], g.device)
    G = (g * pw).sum(-1)
    X = G | (p * pw).sum(-1)
    return (X + G) ^ X ^ G


def _carry_in(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The carry (0 or 1) into each limb (see _carry_mask)."""
    n = g.shape[-1]
    return (_carry_mask(g, p).unsqueeze(-1) >> _arange(n, 1, g.device)) & 1


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Lazy non-negative columns below 2^63 -> canonical limbs of the same
    width; the carry out of the top is dropped.  One pass leaves each limb
    below 2^33, so what is left carries at most 1 a limb."""
    c = x >> LIMB_BITS
    x = x & MASK
    x[..., 1:] += c[..., :-1]
    return (x + _carry_in(x > MASK, x == MASK)) & MASK


def _sub_wrap(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(32 * width) of canonical limbs, and the borrow out
    (a < b)."""
    d = a - b
    cm = _carry_mask(d < 0, d == 0)
    n = d.shape[-1]
    return ((d - ((cm.unsqueeze(-1) >> _arange(n, 1, d.device)) & 1)) & MASK,
            (cm >> n) & 1)


def _add_wrap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^(32 * width) of canonical limbs."""
    s = a + b
    return (s + _carry_in(s > MASK, s == MASK)) & MASK


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def select(mask: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """mask ? a : b, the mask over the leading dimensions."""
    return torch.where(_bcast(mask.bool(), a), a, b)


# ---- field arithmetic on limbs (canonical in, canonical out) ----

def _cond_sub(f: Field, x: torch.Tensor) -> torch.Tensor:
    """x < 2q -> x mod q."""
    d, borrow = _sub_wrap(x, const(f.modulus, x.device, f.nlimb))
    return select(borrow, x, d)


def add(f: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub(f, _add_wrap(a, b))


def sub(f: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_wrap(a, b)
    return select(borrow, _add_wrap(d, const(f.modulus, d.device, f.nlimb)),
                  d)


def neg(f: Field, a: torch.Tensor) -> torch.Tensor:
    return sub(f, torch.zeros_like(a), a)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of n canonical limbs as 2n lazy columns, each the
    sum of at most 2n halves of limb products (below 2^38): the low half of
    a_i * b_j goes to column i + j, the high half to i + j + 1.  Small
    batches take the outer product with each row shifted by its index
    through a pad-and-reshape (few operations); large ones a loop over a's
    limbs (less memory traffic)."""
    nl = a.shape[-1]
    if b.dim() == 1 or a.shape == b.shape:   # the common cases, cheaply
        lead = a.shape[:-1]
    else:
        lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    n = 1
    for d in lead:
        n *= d
    if n > _OUTER_MAX:
        cols = torch.zeros((*lead, 2 * nl), dtype=torch.int64,
                           device=a.device)
        for i in range(nl):
            p = a[..., i : i + 1] * b
            cols[..., i : i + nl] += p & MASK
            cols[..., i + 1 : i + nl + 1] += (p >> LIMB_BITS) & MASK
        return cols
    p = a.unsqueeze(-1) * b.unsqueeze(-2)                 # [..., n, n]
    rows = torch.zeros((*lead, nl, nl + 1), dtype=torch.int64,
                       device=a.device)
    rows[..., :nl] = p & MASK
    rows[..., 1:] += (p >> LIMB_BITS) & MASK              # row i from col i
    # rows 2n + 1 wide read 2n wide: row i moves right by i
    sk = F.pad(rows, (0, nl)).reshape(*lead, nl * (2 * nl + 1))
    return sk[..., : nl * 2 * nl].reshape(*lead, nl, 2 * nl).sum(-2)


_OUTER_MAX = 4096    # batch size up to which _mul_cols takes the outer product


def mul(f: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod q."""
    dev, nl = a.device, f.nlimb
    t = _mul_cols(a, b)
    m = _norm(_mul_cols(_norm(t[..., :nl]),
                        const(f.nprime, dev, nl))[..., :nl])  # mod R
    s = _norm(t + _mul_cols(m, const(f.modulus, dev, nl)))
    return _cond_sub(f, s[..., nl:])


def sqr(f: Field, a: torch.Tensor) -> torch.Tensor:
    return mul(f, a, a)


def is_zero(a: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Whether the element is zero, over its last `dims` dimensions."""
    return (a == 0).flatten(-dims).all(-1)


def one(f: Field, device) -> torch.Tensor:
    return const(f.one, device, f.nlimb)


def pow_int(f: Field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square-and-multiply, the exponent a Python int."""
    res = one(f, a.device).expand_as(a)
    for bit in bin(e)[2:]:
        res = mul(f, res, res)
        if bit == "1":
            res = mul(f, res, a)
    return res


def inv(f: Field, a: torch.Tensor) -> torch.Tensor:
    """a^-1 by Fermat (0 -> 0)."""
    return pow_int(f, a, f.modulus - 2)


def batch_inv(f: Field, a: torch.Tensor) -> torch.Tensor:
    """The inverse of each element of a [n, ..., 2 W] batch with one Fermat
    inversion (Montgomery's trick): prefix and suffix products by doubling
    scans, inv(a_i) = prefix_{<i} * suffix_{>i} / prod.  Zeros must have
    been replaced by the caller."""
    n = a.shape[0]
    o = one(f, a.device).expand_as(a[:1])
    pre, suf, s = a, a, 1
    while s < n:
        pre = torch.cat([pre[:s], mul(f, pre[s:], pre[:-s])])
        suf = torch.cat([mul(f, suf[:-s], suf[s:]), suf[-s:]])
        s *= 2
    total = inv(f, pre[-1:])
    before = torch.cat([o, pre[:-1]])
    after = torch.cat([suf[1:], o])
    return mul(f, mul(f, before, after), total.expand_as(a))


# ---- words in, words out ----

def _words_op(fn):
    @functools.wraps(fn)
    def op(f: Field, *args):
        return words(fn(f, *(limbs(a) for a in args)))
    return op


add_w = _words_op(add)
sub_w = _words_op(sub)
mul_w = _words_op(mul)
sqr_w = _words_op(sqr)
inv_w = _words_op(inv)


def to_mont(f: Field, w: torch.Tensor) -> torch.Tensor:
    """Standard words (below q) -> Montgomery words."""
    x = limbs(w)
    return words(mul(f, x, const(f.r2, w.device, f.nlimb).expand_as(x)))


def from_mont(f: Field, w: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> standard words."""
    x = limbs(w)
    return words(mul(f, x, const(1, w.device, f.nlimb).expand_as(x)))


# ---- Fq2 = Fq[u]/(u^2 + 1) on limbs [..., 2, 2 W], over FQ or FQ381 ----

def f2_mul(a: torch.Tensor, b: torch.Tensor, f: Field = FQ) -> torch.Tensor:
    """Karatsuba: the three base-field products in one batched product."""
    s = add(f, torch.stack([a[..., 0, :], b[..., 0, :]]),
            torch.stack([a[..., 1, :], b[..., 1, :]]))
    x = torch.stack([a[..., 0, :], a[..., 1, :], s[0]], -2)
    y = torch.stack([b[..., 0, :], b[..., 1, :], s[1]], -2)
    t = mul(f, x, y)
    t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
    return torch.stack([sub(f, t0, t1), sub(f, sub(f, t2, t0), t1)], -2)


def f2_inv(a: torch.Tensor, f: Field = FQ) -> torch.Tensor:
    """(a0 - a1 u) / (a0^2 + a1^2)."""
    sq = mul(f, a, a)
    t = inv(f, add(f, sq[..., 0, :], sq[..., 1, :]))
    c = torch.stack([a[..., 0, :], neg(f, a[..., 1, :])], -2)
    return mul(f, c, t.unsqueeze(-2).expand_as(c))


f2_mul_w = _words_op(lambda f, a, b: f2_mul(a, b, f))
f2_inv_w = _words_op(lambda f, a: f2_inv(a, f))
