"""NTT, inverse NTT and coset scale over BN254's Fr for Groth16's quotient
H = (A*B - C) / Z (kernel 3, csrc/fr_ntt.cu).

Port of the transforms of eigen_zkvm_tpu/groth16/groth16.py (`_find_root`,
`_ntt`, `_intt` and the coset steps of `_witness_h`) onto tensors.  Values
are [n, 4] int64 words in Montgomery form (ops/bigint.py), natural order in
and out.  A transform is a bit-reversal gather (torch) and log2(n) radix-2
stages, one kernel launch a stage on a CUDA tensor (`stage`), the plain
ladder on a CPU tensor (`stage_plain`).  The inverse transform's 1/n and
the coset shift's powers are one table product after it (`mul`), and the
pointwise quotient (a*b - c) * k is one more kernel (`quotient`).

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


# ---- stage (kernel 3's butterflies) ----

def stage_plain(x: torch.Tensor, tw: torch.Tensor, log_n: int,
                s: int) -> torch.Tensor:
    """Plain version of fr_ntt_stage: radix-2 stage s (half = 2^s) on a
    bit-reversed buffer, groth16._ntt's inner loop: u, v*w^(j n/2h)."""
    n, h = 1 << log_n, 1 << s
    b = bi.limbs(x).view(n // (2 * h), 2, h, bi.NLIMB)
    w = bi.limbs(tw[:: n // (2 * h)][:h])
    t = bi.mul(FR, b[:, 1], w.expand_as(b[:, 1]))
    u = b[:, 0]
    return bi.words(torch.stack([bi.add(FR, u, t), bi.sub(FR, u, t)],
                                1)).view(n, 4)


def stage(x: torch.Tensor, tw: torch.Tensor, log_n: int, s: int
          ) -> torch.Tensor:
    """One radix-2 stage, in place on a CUDA tensor."""
    if x.device.type == "cpu":
        return stage_plain(x, tw, log_n, s)
    return _stage_cuda(x, tw, log_n, s)


def _stage_cuda(x, tw, log_n, s):
    kernels.FR_NTT.launch(x.device.index, x.data_ptr(), tw.data_ptr(),
                          log_n, s, stream=_stream(x.device),
                          entry="fr_ntt_stage")
    return x


def _transform(x: torch.Tensor, log_n: int, inverse: bool,
               stage_fn) -> torch.Tensor:
    x = _check(x, 1 << log_n)
    tw = twiddles(log_n, inverse, x.device)
    y = x[bit_reverse(log_n, x.device)]
    for s in range(log_n):
        y = stage_fn(y, tw, log_n, s)
    return y


def ntt(x: torch.Tensor, log_n: int, inverse: bool = False
        ) -> torch.Tensor:
    """Natural-order NTT of [2^log_n, 4] Montgomery words with the root of
    order n (inverse: its inverse, no 1/n scale)."""
    return _transform(x, log_n, inverse, stage)


def ntt_plain(x: torch.Tensor, log_n: int, inverse: bool = False
              ) -> torch.Tensor:
    return _transform(x, log_n, inverse, stage_plain)


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

def to_coset(evals: torch.Tensor, log_n: int) -> torch.Tensor:
    """Evaluations on the subgroup -> evaluations on SHIFT * subgroup."""
    coeffs = mul(ntt(evals, log_n, inverse=True),
                 coset_scale(log_n, False, evals.device))
    return ntt(coeffs, log_n)


def from_coset(evals: torch.Tensor, log_n: int) -> torch.Tensor:
    """Evaluations on SHIFT * subgroup -> coefficients."""
    return mul(ntt(evals, log_n, inverse=True),
               coset_scale(log_n, True, evals.device))


def z_coset_inv(m: int) -> int:
    """1 / Z(SHIFT * x) = 1 / (SHIFT^m - 1), constant on the coset."""
    return pow((pow(SHIFT, m, R) - 1) % R, R - 2, R)
