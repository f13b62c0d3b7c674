"""NTT, inverse NTT and coset scale over BN254's Fr for Groth16's quotient
H = (A*B - C) / Z (kernel 3, csrc/fr_ntt.cu).

Port of the transforms of eigen_zkvm_tpu/groth16/groth16.py (`_find_root`,
`_ntt`, `_intt` and the coset steps of `_witness_h`) onto tensors.  Values
are [n, 4] int64 words in Montgomery form (ops/bigint.py), natural order in
and out.  A transform of 2^L values is a four-step of `plan(L)` passes of
at most TILE_BITS bits (two at 2^21 and 2^22, three up to 2^28): a pass
runs the short transforms down the columns of a [2^b, 2^(L-b)] view, the
four-step factor and a transposed store (`ntt_pass`: one kernel launch on
a CUDA tensor, `pass_plain` on a CPU tensor).  No pass gathers its input in
device memory.  The inverse transform's 1/n and the coset shift's powers
ride on its last pass; the pointwise quotient (a*b - c) * k and the
Montgomery conversions are one launch each (`quotient`, `mul`).
`ntt_plain` (a bit-reversal gather and log2(n) radix-2 stages) is the
reference the passes are held against.

Twiddle and scale tables are built once per (size, device) on the device,
by doubling with the plain product.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from . import bigint as bi
from .bigint import FR

R = FR.modulus
SHIFT = 5   # the coset shift of groth16._witness_h: any non-subgroup element
TILE_BITS = 11   # rows of a pass's tile at most (csrc/fr_ntt.cu kMaxBits)


def find_root(r: int, m: int) -> int:
    """Primitive m-th root of unity in F_r (m a power of two);
    groth16._find_root."""
    two_adic = (r - 1) & -(r - 1)
    assert m <= two_adic, "domain too large for field 2-adicity"
    g = 5
    while pow(g, (r - 1) // 2, r) == 1:
        g += 1
    return pow(g, (r - 1) // m, r)


def _powers(x: int, n: int, scale: int, device) -> torch.Tensor:
    """scale * x^i for i < n, Montgomery words, by doubling: the first k
    values times x^k are the next k.  The plain product on every device, so
    that the tables the kernel's transforms and their plain versions share
    do not depend on the kernel."""
    out = bi.mont_ints(FR, [scale], device)
    k = 1
    while k < n:
        out = torch.cat([out, mul_plain(
            out[: n - k], bi.mont_ints(FR, [pow(x, k, R)], device))])
        k *= 2
    return out


@functools.lru_cache(maxsize=16)
def twiddles(log_n: int, inverse: bool, device: torch.device
             ) -> torch.Tensor:
    """w^j for j < n/2 (w the root of order n, or its inverse), Montgomery
    words."""
    w = find_root(R, 1 << log_n)
    if inverse:
        w = pow(w, R - 2, R)
    return _powers(w, max(1, (1 << log_n) // 2), 1, device)


@functools.lru_cache(maxsize=16)
def coset_scale(log_n: int, inverse: bool, device: torch.device
                ) -> torch.Tensor:
    """n^-1 * SHIFT^i (to the coset) or n^-1 * SHIFT^-i (back from it) for
    i < n, Montgomery words."""
    n = 1 << log_n
    s = pow(SHIFT, R - 2, R) if inverse else SHIFT
    return _powers(s, n, pow(n, R - 2, R), device)


@functools.lru_cache(maxsize=16)
def bit_reverse(log_n: int, device: torch.device) -> torch.Tensor:
    n = 1 << log_n
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.to(device)


@functools.lru_cache(maxsize=4)
def mont_const(value: int, device: torch.device) -> torch.Tensor:
    """One Montgomery-form constant as [1, 4] words."""
    return bi.mont_ints(FR, [value], device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != 4 or \
            (n is not None and x.shape[0] != n):
        raise ValueError(f"Fr values: int64 [n, 4], got {x.dtype} "
                         f"{tuple(x.shape)}")
    return x.contiguous()


# ---- passes (kernel 3's transforms) ----

def plan(log_n: int, tile_bits: int = TILE_BITS) -> list[int]:
    """The bits of each pass of a transform of 2^log_n values: as few
    passes of at most `tile_bits` as cover log_n, as even as possible,
    deepest first (2^21: 11, 10; 2^23: 8, 8, 7; 2^7 at 3: 3, 2, 2)."""
    if not 1 <= tile_bits <= TILE_BITS:
        raise ValueError(f"tile bits {tile_bits} outside 1..{TILE_BITS}")
    passes = max(1, -(-log_n // tile_bits))
    depth, deeper = divmod(log_n, passes)
    return [depth + (p < deeper) for p in range(passes)]


@functools.lru_cache(maxsize=16)
def stage_twiddles(log_n: int, inverse: bool, device: torch.device
                   ) -> torch.Tensor:
    """A pass's stage twiddles: [h + j] = w_(2h)^j for j < h, h = 2^s,
    s < min(log_n, TILE_BITS) ([0] = 1), w_(2h) the root of order 2h (or
    its inverse), gathered from `twiddles(log_n, inverse)`."""
    tw = twiddles(log_n, inverse, device)
    n = 1 << log_n
    return torch.cat([tw[:1]] + [tw[:: n >> (s + 1)][: 1 << s]
                                 for s in range(min(log_n, TILE_BITS))])


def pass_plain(x: torch.Tensor, log_n: int, lo: int, bits: int,
               inverse: bool = False, post: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Plain version of fr_ntt_pass: x viewed as [2^bits, 2^(log_n - bits)]
    row-major, a length-2^bits transform down each column (rows
    bit-reversed, radix-2 decimation-in-time stages with the twiddles of
    `stage_twiddles`), value (r, c) times the four-step factor
    w^((g r) 2^lo), g = c >> lo, then stored to
    out[(g 2^bits + r) 2^lo + (c mod 2^lo)]; `post` (the last pass only,
    lo + bits = log_n) scales the natural-order output."""
    n, rows = 1 << log_n, 1 << bits
    width = n >> bits
    dev = x.device
    st = bi.limbs(stage_twiddles(log_n, inverse, dev))
    y = bi.limbs(x).view(rows, width, bi.NLIMB)[bit_reverse(bits, dev)]
    for s in range(bits):
        h = 1 << s
        b = y.view(rows // (2 * h), 2, h, width, bi.NLIMB)
        t = bi.mul(FR, b[:, 1], st[h : 2 * h, None].expand_as(b[:, 1]))
        u = b[:, 0]
        y = torch.stack([bi.add(FR, u, t), bi.sub(FR, u, t)], 1).view(
            rows, width, bi.NLIMB)
    if lo + bits < log_n:  # the four-step factor
        g = torch.arange(width, device=dev) >> lo
        e = (torch.arange(rows, device=dev)[:, None] * g) << lo
        tw = bi.limbs(twiddles(log_n, inverse, dev))
        f = bi.mul(FR, y, tw[e & (n // 2 - 1)])
        y = bi.select(e >= n // 2, bi.neg(FR, f), f)
    if post is not None:
        y = bi.mul(FR, y, bi.limbs(post).view(rows, width, bi.NLIMB))
    return bi.words(y).view(rows, width >> lo, 1 << lo, 4).transpose(
        0, 1).reshape(n, 4)


def ntt_pass(x: torch.Tensor, log_n: int, lo: int, bits: int,
             inverse: bool = False, post: torch.Tensor | None = None
             ) -> torch.Tensor:
    """One pass (`pass_plain`) into a new tensor: the kernel on a CUDA
    tensor."""
    if x.device.type == "cpu":
        return pass_plain(x, log_n, lo, bits, inverse, post)
    return _pass_cuda(x, log_n, lo, bits, inverse, post)


def _pass_cuda(x, log_n, lo, bits, inverse, post):
    tw = twiddles(log_n, inverse, x.device)
    st = stage_twiddles(log_n, inverse, x.device)
    if any(t.data_ptr() % 16 for t in (x, tw, st) + (
            () if post is None else (post,))):
        raise ValueError("fr_ntt_pass needs 16-byte aligned tensors")
    out = torch.empty_like(x)
    kernels.FR_NTT.launch(x.device.index, x.data_ptr(), out.data_ptr(),
                          tw.data_ptr(), st.data_ptr(),
                          kernels.pointer(post), log_n, lo, bits,
                          stream=_stream(x.device))
    return out


def _transform(x: torch.Tensor, log_n: int, inverse: bool,
               post: torch.Tensor | None = None,
               tile_bits: int = TILE_BITS) -> torch.Tensor:
    """The passes of `plan(log_n, tile_bits)`, `post` on the last."""
    x = _check(x, 1 << log_n)
    lo = 0
    for bits in plan(log_n, tile_bits):
        last = lo + bits == log_n
        x = ntt_pass(x, log_n, lo, bits, inverse, post if last else None)
        lo += bits
    return x


def ntt(x: torch.Tensor, log_n: int, inverse: bool = False, *,
        tile_bits: int = TILE_BITS) -> torch.Tensor:
    """Natural-order NTT of [2^log_n, 4] Montgomery words with the root of
    order n (inverse: its inverse, no 1/n scale), as passes of at most
    `tile_bits`; x is left as it was."""
    return _transform(x, log_n, inverse, tile_bits=tile_bits)


def stage_plain(x: torch.Tensor, tw: torch.Tensor, log_n: int,
                s: int) -> torch.Tensor:
    """Radix-2 stage s (half = 2^s) on a bit-reversed buffer, groth16._ntt's
    inner loop: u, v*w^(j n/2h)."""
    n, h = 1 << log_n, 1 << s
    b = bi.limbs(x).view(n // (2 * h), 2, h, bi.NLIMB)
    w = bi.limbs(tw[:: n // (2 * h)][:h])
    t = bi.mul(FR, b[:, 1], w.expand_as(b[:, 1]))
    u = b[:, 0]
    return bi.words(torch.stack([bi.add(FR, u, t), bi.sub(FR, u, t)],
                                1)).view(n, 4)


def ntt_plain(x: torch.Tensor, log_n: int, inverse: bool = False
              ) -> torch.Tensor:
    """The reference ladder, independent of the passes: a bit-reversal
    gather and log_n radix-2 stages (`stage_plain`) over the whole
    vector."""
    x = _check(x, 1 << log_n)
    tw = twiddles(log_n, inverse, x.device)
    y = x[bit_reverse(log_n, x.device)]
    for s in range(log_n):
        y = stage_plain(y, tw, log_n, s)
    return y


# ---- pointwise (kernel 3's product and quotient) ----

def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product, b [n, 4] or one value [1, 4]."""
    x = bi.limbs(a)
    return bi.words(bi.mul(FR, x, bi.limbs(b).expand_as(x)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _check(a), _check(b)
    if a.device.type == "cpu":
        return mul_plain(a, b)
    return _mul_cuda(a, b)


def _mul_cuda(a, b):
    if b.shape[0] not in (1, a.shape[0]):
        raise ValueError(f"fr mul of {a.shape[0]} by {b.shape[0]} values")
    out = torch.empty_like(a)
    if a.shape[0]:
        kernels.FR_NTT.launch(a.device.index, a.data_ptr(), b.data_ptr(),
                              int(b.shape[0] != 1), out.data_ptr(),
                              a.shape[0], stream=_stream(a.device),
                              entry="fr_mul")
    return out


def quotient_plain(a, b, c, k) -> torch.Tensor:
    """(a*b - c) * k, k one value [1, 4]."""
    ab = bi.mul(FR, bi.limbs(a), bi.limbs(b))
    d = bi.sub(FR, ab, bi.limbs(c))
    return bi.words(bi.mul(FR, d, bi.limbs(k).expand_as(d)))


def quotient(a, b, c, k) -> torch.Tensor:
    a, b, c, k = (_check(v) for v in (a, b, c, k))
    if a.device.type == "cpu":
        return quotient_plain(a, b, c, k)
    return _quotient_cuda(a, b, c, k)


def _quotient_cuda(a, b, c, k):
    out = torch.empty_like(a)
    kernels.FR_NTT.launch(a.device.index, a.data_ptr(), b.data_ptr(),
                          c.data_ptr(), k.data_ptr(), out.data_ptr(),
                          a.shape[0], stream=_stream(a.device),
                          entry="fr_quotient")
    return out


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Standard words -> Montgomery (a product by R^2)."""
    return mul(x, bi.to_tensor([FR.r2], x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """Montgomery words -> standard (a product by 1)."""
    return mul(x, bi.to_tensor([1], x.device))


# ---- the coset steps of groth16._witness_h ----

def to_coset(evals: torch.Tensor, log_n: int, *,
             tile_bits: int = TILE_BITS) -> torch.Tensor:
    """Evaluations on the subgroup -> evaluations on SHIFT * subgroup: the
    inverse transform with n^-1 SHIFT^i on its last pass, then the forward
    one."""
    coeffs = _transform(evals, log_n, True,
                        coset_scale(log_n, False, evals.device), tile_bits)
    return ntt(coeffs, log_n, tile_bits=tile_bits)


def from_coset(evals: torch.Tensor, log_n: int, *,
               tile_bits: int = TILE_BITS) -> torch.Tensor:
    """Evaluations on SHIFT * subgroup -> coefficients: the inverse
    transform with n^-1 SHIFT^-i on its last pass."""
    return _transform(evals, log_n, True,
                      coset_scale(log_n, True, evals.device), tile_bits)


def to_coset_plain(evals: torch.Tensor, log_n: int) -> torch.Tensor:
    scale = coset_scale(log_n, False, evals.device)
    return ntt_plain(mul_plain(ntt_plain(evals, log_n, True), scale), log_n)


def from_coset_plain(evals: torch.Tensor, log_n: int) -> torch.Tensor:
    scale = coset_scale(log_n, True, evals.device)
    return mul_plain(ntt_plain(evals, log_n, True), scale)


def z_coset_inv(m: int) -> int:
    """1 / Z(SHIFT * x) = 1 / (SHIFT^m - 1), constant on the coset."""
    return pow((pow(SHIFT, m, R) - 1) % R, R - 2, R)
