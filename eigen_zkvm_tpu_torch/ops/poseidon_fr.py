"""Batched Poseidon over a big field (BN254's or BLS12-381's scalar field).

Port of eigen_zkvm_tpu/hash/poseidon_big.py::hash_batch_limbs, whose work
the JAX package does in host C++ (native/poseidon_fr.cpp `posfr_hash_batch`,
:432) with no Pallas kernel; here it is csrc/poseidon_fr.cu on the card.
Values cross as [..., 4] int64 words in value form (the u64 limbs of the
JAX package's limb arrays); inside, the permutation runs in Montgomery form
on the tables of hash/poseidon_big.py::PoseidonBig.device_tables.

`permute(field, t, inp, init, n_out)` launches the kernel for CUDA tensors
and runs the plain version (`permute_plain`) for CPU tensors.  The plain
version is `permute_limbs`, batched tensor code on ops/bigint.py (the
reference the kernel is held to on the card), except on CPU tensors,
where each state runs the host permutation on Python ints (about 2 ms a
t = 17 state on one core, against 13-27 ms a state for the limb
arithmetic: the CPU tests prove big-field layers of 2^12 rows).  The
kernel carries a permutation on one thread or on a group of threads,
whose size `plan` picks from the width and the batch.
`field` is bigint.FR (BN128) or bigint.FR_BLS (BLS12381).  The schedule
is that of PoseidonBig.hash_ex: the first add of C, half - 1 full rounds
with M, one with P, n_p partial rounds with the sparse S (one S-box on
lane 0; new lane 0 = sum S * state; lanes k >= 1 += S * s0), half - 1
full rounds with M, a last full round with no constant.
"""
from __future__ import annotations

import math

import torch

from .. import kernels
from ..hash import poseidon_bls12381, poseidon_bn128
from ..hash.poseidon_big import N_ROUNDS_F, PoseidonBig
from . import bigint as bi

_HALF = N_ROUNDS_F // 2
# the kernel's field index and the Poseidon instance of each field
_FIELDS = {bi.FR: (0, poseidon_bn128.POSEIDON),
           bi.FR_BLS: (1, poseidon_bls12381.POSEIDON)}


# threads a permutation the kernel takes (1: the one-thread kernel, any
# width; more: the group kernel), and the most state lanes one thread of a
# group may own (its instances own 1, 2, 3 or 5)
LANES = (1, 2, 4, 8, 16, 32)
MAX_OWNED = 5
# The warps a scheduler below which a permutation's chain runs no faster:
# on the H100 a lone warp's chain took 1.1-1.3 times as long as the same
# chain among warps that kept every scheduler busy (bench_poseidon_fr
# --sweep: t = 17 at one state against 2^14, every group size)
LATENCY = 1.2
SCHEDULERS_PER_SM = 4
SHUFFLE_ADD = 0.125   # a shuffle of 8 words and an add, in products


def lane_choices(t: int) -> tuple:
    """The group sizes the kernel takes at width t: one thread (any t), or
    groups where each thread owns at most MAX_OWNED lanes and no group is
    twice as wide as the state."""
    return tuple(g for g in LANES
                 if g == 1 or (-(-t // g) <= MAX_OWNED and g < 2 * t))


def chain_products(t: int, n_p: int, lanes: int) -> float:
    """Field products on one thread's serial chain for a permutation of
    width t on a group of `lanes` threads, each owning E = ceil(t / lanes)
    state lanes: in each of the 8 full rounds E S-boxes (3 products) and E
    rows of the mix (t products); in each partial round s0's S-box, E terms
    and E updates, and log2(lanes) shuffle-adds for the sum."""
    E = -(-t // lanes)
    return (8 * E * (3 + t) + n_p * (3 + 2 * E)
            + n_p * math.log2(lanes) * SHUFFLE_ADD)


def plan(t: int, n_p: int, B: int, sms: int = 132) -> tuple[int, int]:
    """(lanes, threads): the group size and block size for B permutations
    of width t on a card of `sms` SMs.

    A batch's time goes as its chain (`chain_products`) times the warps
    each scheduler holds, and no lower than the chain times LATENCY (a
    chain runs no faster with fewer warps).  So a batch that fills the
    card takes the smallest group the widths allow (the fewest
    instructions: G = 1 for the leaves), one that leaves the card idle a
    group as wide as the state (the shortest chain); between the two, the
    least of chain x max(LATENCY, warps a scheduler); blocks as
    `plan_threads` sizes them."""
    slots = sms * SCHEDULERS_PER_SM

    def cost(g):
        warps = -(-B * g // 32)
        return chain_products(t, n_p, g) * max(LATENCY, warps / slots), g

    lanes = min(cost(g) for g in lane_choices(t))[1]
    return lanes, plan_threads(B, lanes, sms)


def plan_threads(B: int, lanes: int, sms: int = 132) -> int:
    """Threads a block for B groups of `lanes`: 128, or 64 or 32 where
    fewer blocks than SMs would leave SMs idle."""
    threads = 32 * -(-B * lanes // 32)
    for block in (128, 64):
        if -(-threads // block) >= sms:
            return block
    return 32


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
    words).  CPU tensors: PoseidonBig.hash_ex on each state's Python ints;
    any other device: `permute_limbs`."""
    if inp.device.type != "cpu":
        return permute_limbs(field, t, inp, init, n_out)
    pos, k = poseidon(field), t - 1
    ins, inits = bi.to_ints(inp), bi.to_ints(init)
    out = [v for b, s in enumerate(inits)
           for v in pos.hash_ex(ins[b * k : (b + 1) * k], s, n_out)]
    return bi.to_tensor(out).view(-1, n_out, 4)


def permute_limbs(field: bi.Field, t: int, inp: torch.Tensor,
                  init: torch.Tensor, n_out: int) -> torch.Tensor:
    """The permutation as batched limb arithmetic on any device (ops/
    bigint.py, Montgomery form): inp [B, t-1, 4], init [B, 4] -> [B,
    n_out, 4] value-form words."""
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
            n_out: int = 1, lanes: int | None = None) -> torch.Tensor:
    """inp [B, t-1, 4] and the capacity init [B, 4] (canonical values) ->
    the first n_out lanes of each permuted state, [B, n_out, 4].  `lanes`
    sets the kernel's group size (one of `lane_choices(t)`; None: `plan`'s
    pick)."""
    _check(t, inp, init, n_out)
    if lanes is not None and lanes not in lane_choices(t):
        raise ValueError(f"poseidon_fr: {lanes} lanes at t = {t}; the "
                         f"kernel takes {lane_choices(t)}")
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
    n_p = pos.n_rounds_p(t)
    sms = torch.cuda.get_device_properties(inp.device).multi_processor_count
    if lanes is None:
        g, threads = plan(t, n_p, B, sms)
    else:
        g, threads = lanes, plan_threads(B, lanes, sms)
    kernels.POSEIDON_FR.launch(
        inp.device.index, fidx, t, n_p, g, threads, tab["C"].data_ptr(),
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
