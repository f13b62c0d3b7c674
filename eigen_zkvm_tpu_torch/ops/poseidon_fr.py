"""Batched Poseidon over a big field (BN254's or BLS12-381's scalar field).

Port of eigen_zkvm_tpu/hash/poseidon_big.py::hash_batch_limbs, whose work
the JAX package does in host C++ (native/poseidon_fr.cpp `posfr_hash_batch`,
:432) with no Pallas kernel; here it is csrc/poseidon_fr.cu on the card.
Values cross as [..., 4] int64 words in value form (the u64 limbs of the
JAX package's limb arrays); inside, the permutation runs in Montgomery form
on the tables of hash/poseidon_big.py::PoseidonBig.device_tables.

`permute(field, t, inp, init, n_out)` launches the kernel for CUDA tensors
and runs the plain version (`permute_plain`, tensor code on ops/bigint.py)
for CPU tensors.  `field` is bigint.FR (BN128) or bigint.FR_BLS
(BLS12381).  The schedule is that of PoseidonBig.hash_ex: the first add of
C, half - 1 full rounds with M, one with P, n_p partial rounds with the
sparse S (one S-box on lane 0; new lane 0 = sum S * state; lanes k >= 1 +=
S * s0), half - 1 full rounds with M, a last full round with no constant.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..hash import poseidon_bls12381, poseidon_bn128
from ..hash.poseidon_big import N_ROUNDS_F, PoseidonBig
from . import bigint as bi

_HALF = N_ROUNDS_F // 2
# the kernel's field index and the Poseidon instance of each field
_FIELDS = {bi.FR: (0, poseidon_bn128.POSEIDON),
           bi.FR_BLS: (1, poseidon_bls12381.POSEIDON)}


def poseidon(field: bi.Field) -> PoseidonBig:
    return _FIELDS[field][1]


def _tables_limbs(pos: PoseidonBig, t: int, device) -> dict:
    return {k: bi.limbs(v) for k, v in pos.device_tables(t, device).items()}


def _sum_mod(f: bi.Field, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of canonical limbs [..., k, ..., 8] over `dim` mod the field,
    by a tree of additions."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = bi.add(f, x[:h], x[h : 2 * h])
        x = torch.cat([s, x[2 * h :]]) if x.shape[0] & 1 else s
    return x[0]


def _pow5(f: bi.Field, x: torch.Tensor) -> torch.Tensor:
    x2 = bi.mul(f, x, x)
    return bi.mul(f, bi.mul(f, x2, x2), x)


def _mix(f: bi.Field, st: torch.Tensor, mat: torch.Tensor, t: int):
    """out[:, i] = sum_j mat[j, i] * st[:, j]; st [B, t, 8], mat [t*t, 8]."""
    prods = bi.mul(f, st[:, :, None, :], mat.view(t, t, bi.NLIMB)[None])
    return _sum_mod(f, prods, 1)


def permute_plain(field: bi.Field, t: int, inp: torch.Tensor,
                  init: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of the kernel: inp [B, t-1, 4], init [B, 4] -> the
    first n_out lanes of the permuted states, [B, n_out, 4] (value-form
    words)."""
    f = field
    pos = poseidon(f)
    k = _tables_limbs(pos, t, inp.device)
    C, S = k["C"], k["S"]
    n_p = pos.n_rounds_p(t)
    r2 = bi.const(f.r2, inp.device)
    st = bi.mul(f, bi.limbs(torch.cat([init[:, None], inp], dim=1)), r2)
    st = bi.add(f, st, C[:t])
    for r in range(_HALF - 1):
        st = bi.add(f, _pow5(f, st), C[(r + 1) * t : (r + 2) * t])
        st = _mix(f, st, k["M"], t)
    st = bi.add(f, _pow5(f, st), C[_HALF * t : (_HALF + 1) * t])
    st = _mix(f, st, k["P"], t)
    for r in range(n_p):
        base = (2 * t - 1) * r
        s0 = bi.add(f, _pow5(f, st[:, 0]), C[(_HALF + 1) * t + r])
        new0 = _sum_mod(f, bi.mul(f, torch.cat([s0[:, None], st[:, 1:]], 1),
                                  S[base : base + t]), 1)
        tail = bi.add(f, st[:, 1:],
                      bi.mul(f, s0[:, None], S[base + t : base + 2 * t - 1]))
        st = torch.cat([new0[:, None], tail], dim=1)
    cbase = (_HALF + 1) * t + n_p
    for r in range(_HALF - 1):
        st = bi.add(f, _pow5(f, st), C[cbase + r * t : cbase + (r + 1) * t])
        st = _mix(f, st, k["M"], t)
    st = _mix(f, _pow5(f, st), k["M"], t)[:, :n_out]
    return bi.words(bi.mul(f, st, bi.const(1, inp.device)))


def _check(t: int, inp: torch.Tensor, init: torch.Tensor, n_out: int):
    B = inp.shape[0]
    if not 2 <= t <= 17 or not 1 <= n_out <= t:
        raise ValueError(f"poseidon_fr: t = {t}, n_out = {n_out}")
    if inp.shape != (B, t - 1, 4) or init.shape != (B, 4) \
            or inp.dtype != torch.int64 or init.dtype != torch.int64:
        raise ValueError(f"poseidon_fr: expected int64 [B, {t - 1}, 4] and "
                         f"[B, 4], got {inp.dtype} {tuple(inp.shape)} and "
                         f"{init.dtype} {tuple(init.shape)}")


def permute(field: bi.Field, t: int, inp: torch.Tensor, init: torch.Tensor,
            n_out: int = 1) -> torch.Tensor:
    """inp [B, t-1, 4] and the capacity init [B, 4] (canonical values) ->
    the first n_out lanes of each permuted state, [B, n_out, 4]."""
    _check(t, inp, init, n_out)
    if inp.device.type == "cpu":
        return permute_plain(field, t, inp, init, n_out)
    if not inp.is_cuda or init.device != inp.device:
        raise ValueError(f"no big-field Poseidon for {inp.device} and "
                         f"{init.device}")
    fidx, pos = _FIELDS[field]
    tab = pos.device_tables(t, inp.device)
    inp, init = inp.contiguous(), init.contiguous()
    B = inp.shape[0]
    out = torch.empty((B, n_out, 4), dtype=torch.int64, device=inp.device)
    if B == 0:  # no states: nothing to launch or count
        return out
    kernels.POSEIDON_FR.launch(
        inp.device.index, fidx, t, pos.n_rounds_p(t), tab["C"].data_ptr(),
        tab["M"].data_ptr(), tab["P"].data_ptr(), tab["S"].data_ptr(),
        inp.data_ptr(), init.data_ptr(), out.data_ptr(), n_out, B,
        stream=torch.cuda.current_stream(inp.device).cuda_stream)
    return out


def _hash_fr(perm, field: bi.Field, inp: torch.Tensor,
             init: torch.Tensor | None) -> torch.Tensor:
    idx = poseidon(field).hash_index
    if init is None:
        init = torch.zeros((inp.shape[0], 4), dtype=torch.int64,
                           device=inp.device)
    return perm(field, inp.shape[1] + 1, inp, init, idx + 1)[:, idx]


def hash_fr(field: bi.Field, inp: torch.Tensor,
            init: torch.Tensor | None = None) -> torch.Tensor:
    """The hash of each row of inp [B, c, 4] (1 <= c <= 16) with capacity
    init (None: zero): the field's hash lane of the permutation, [B, 4]."""
    return _hash_fr(permute, field, inp, init)


def hash_fr_plain(field: bi.Field, inp: torch.Tensor,
                  init: torch.Tensor | None = None) -> torch.Tensor:
    """hash_fr on permute_plain, on any device."""
    return _hash_fr(permute_plain, field, inp, init)
