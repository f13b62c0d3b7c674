"""R1CS evaluation over BN254's Fr: A*w, B*w and C*w for Groth16's quotient,
padded to the domain with the publics in A's tail (kernel 4, csrc/r1cs.cu).

Port of the sparse evaluation of eigen_zkvm_tpu/groth16/groth16.py
(`_r1cs_csr`, `_witness_h` :315-341).  `build` turns a constraint list into
`Rows`, once a circuit: the 3 nc rows of A, B and C as one CSR with int32
row offsets and wires, and the index of each nonzero's coefficient in a
table of the distinct coefficients in Montgomery form, 1 and -1 first (a
circuit reuses a handful of values, 1, -1 and gate constants, millions of
times), as int16 when the table allows it.  The rows are stored in the
kernel's order: the rows of at most SHORT_MAX nonzeros (a thread each)
by their count of products (nonzeros whose coefficient is not +-1) and
then by length, the longer rows (a warp each) after them, each row's
products before its +-1 terms; `dest` holds each stored row's place
s nc + j.  The witness is [n_vars, 4] Montgomery words.

`evaluate` returns [3, m, 4] Montgomery words: slot (s, j) is row j of
matrix s for j < nc, A's slots nc..nc+n_pub-1 hold the witness's first
n_pub values, every other slot is zero.  A CUDA tensor goes to the kernel
(one launch); the plain version multiplies every nonzero, sums each row's
products in 32-bit limbs with `index_add_`, reduces the sums mod r and
puts each in its slot.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from . import bigint as bi
from .bigint import FR

# Rows of more nonzeros than this take a warp in the kernel: timed on the
# card (kernel_tune --r1cs, PERF.md section 6), rows of 16 were 2.6x
# faster a thread a row, rows of 32 8-18 % faster a warp a row.
SHORT_MAX = 16


@dataclass
class Rows:
    nc: int                  # constraints: rows of each matrix
    indptr: torch.Tensor     # [3 nc + 1] int32, rows in stored order
    wires: torch.Tensor      # [nnz] int32
    cidx: torch.Tensor       # [nnz] int16 or int32, into coefs
    coefs: torch.Tensor      # [distinct, 4] Montgomery words; 1, -1 first
    dest: torch.Tensor       # [3 nc] int32: a stored row's s nc + j
    n_short: int             # stored rows 0..n_short-1: a thread each

    @property
    def nnz(self) -> int:
        return self.wires.numel()


def build(constraints, device) -> Rows:
    """The rows of a list of ({wire: coef},) * 3 constraints."""
    r = FR.modulus
    uniq: dict = {1: 0, r - 1: 1}
    nc = len(constraints)
    lens = np.empty(3 * nc, dtype=np.int64)
    wires, cidx = [], []
    for sel in range(3):
        for j, row in enumerate(constraints):
            side = row[sel]
            lens[sel * nc + j] = len(side)
            for s, c in side.items():
                wires.append(s)
                cidx.append(uniq.setdefault(c % r, len(uniq)))
    wires = np.asarray(wires, dtype=np.int64)
    if wires.size >= 1 << 31 or (wires.size and wires.max() >= 1 << 31):
        raise ValueError("the kernel's int32 offsets and wires hold at "
                         "most 2^31 - 1 nonzeros and wires")
    ctype = np.int16 if len(uniq) <= 1 << 15 else np.int32

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype=dtype)).to(device)

    # the stored order, on the device: short rows by their products, then
    # their length (a key below (SHORT_MAX + 1)^2), long rows last; each
    # row's products first
    lens, wires = tensor(lens, np.int64), tensor(wires, np.int32)
    cidx = tensor(cidx, ctype)
    n, nnz = 3 * nc, wires.numel()
    row_of = torch.repeat_interleave(torch.arange(n, device=device), lens)
    is_prod = cidx >= 2
    products = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
        0, row_of, is_prod.long())
    key = torch.where(lens > SHORT_MAX, (SHORT_MAX + 1) ** 2,
                      products * (SHORT_MAX + 1) + lens)
    order = torch.sort(key, stable=True).indices
    place = torch.empty_like(order)
    place[order] = torch.arange(n, device=device)
    indptr = F.pad(lens[order].cumsum(0), (1, 0))
    start = F.pad(lens.cumsum(0), (1, 0))[row_of]
    before = F.pad(is_prod.long().cumsum(0), (1, 0))
    prod_before = before[:-1] - before[start]
    rank = torch.where(is_prod, prod_before,
                       products[row_of] + torch.arange(nnz, device=device)
                       - start - prod_before)
    pos = indptr[place[row_of]] + rank
    stored_wires, stored_cidx = torch.empty_like(wires), torch.empty_like(cidx)
    stored_wires[pos], stored_cidx[pos] = wires, cidx
    return Rows(nc=nc, indptr=indptr.to(torch.int32), wires=stored_wires,
                cidx=stored_cidx, coefs=bi.mont_ints(FR, list(uniq), device),
                dest=order.to(torch.int32),
                n_short=int((lens <= SHORT_MAX).sum()))


def _sums_plain(rows: Rows, wit: torch.Tensor, lo: int, hi: int):
    """Stored rows lo..hi-1: [hi - lo, 4] Montgomery words."""
    ptr = rows.indptr[lo : hi + 1].long()
    lens = ptr.diff()
    seg = slice(int(ptr[0]), int(ptr[-1]))
    row = torch.repeat_interleave(torch.arange(hi - lo, device=wit.device),
                                  lens)
    prod = bi.mul(FR, bi.limbs(rows.coefs[rows.cidx[seg].long()]),
                  bi.limbs(wit[rows.wires[seg].long()]))
    acc = torch.zeros((hi - lo, bi.NLIMB), dtype=torch.int64,
                      device=wit.device)
    acc.index_add_(0, row, prod)
    # a row sums fewer than 2^k values below r: two more limbs hold it
    # exactly, and k conditional subtractions of r * 2^j bring it below r
    k = max(1, int(lens.max()).bit_length()) if hi > lo else 1
    x = bi._norm(F.pad(acc, (0, 2)))
    for j in range(k - 1, -1, -1):
        d, borrow = bi._sub_wrap(x, bi.const(FR.modulus << j, x.device,
                                             bi.NLIMB + 2))
        x = bi.select(borrow, x, d)
    return bi.words(x[..., : bi.NLIMB])


def evaluate_plain(rows: Rows, wit: torch.Tensor, m: int,
                   n_pub: int) -> torch.Tensor:
    """Plain version of r1cs_eval: [3, m, 4] Montgomery words."""
    nc = rows.nc
    out = torch.zeros((3, m, 4), dtype=torch.int64, device=wit.device)
    flat = out.view(3 * m, 4)
    dest = rows.dest.long()
    slots = dest // max(nc, 1) * m + dest % max(nc, 1)
    for lo in range(0, 3 * nc, max(nc, 1)):  # a third at a time: memory
        hi = min(lo + nc, 3 * nc)
        flat[slots[lo:hi]] = _sums_plain(rows, wit, lo, hi)
    out[0, nc : nc + n_pub] = wit[:n_pub]
    return out


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def evaluate(rows: Rows, wit: torch.Tensor, m: int, n_pub: int
             ) -> torch.Tensor:
    """A*w, B*w and C*w padded to m rows, the publics in A's: kernel 4
    for a CUDA tensor."""
    if wit.dtype != torch.int64 or wit.dim() != 2 or wit.shape[1] != 4:
        raise ValueError(f"witness: int64 [n, 4], got {tuple(wit.shape)}")
    if m < rows.nc + n_pub or n_pub > wit.shape[0]:
        raise ValueError(f"{rows.nc} rows and {n_pub} publics do not fit "
                         f"a domain of {m}")
    wit = wit.contiguous()
    if wit.device.type == "cpu":
        return evaluate_plain(rows, wit, m, n_pub)
    return _evaluate_cuda(rows, wit, m, n_pub)


def _evaluate_cuda(rows: Rows, wit: torch.Tensor, m: int,
                   n_pub: int) -> torch.Tensor:
    for t, dtypes in ((rows.indptr, (torch.int32,)),
                      (rows.wires, (torch.int32,)),
                      (rows.cidx, (torch.int16, torch.int32)),
                      (rows.coefs, (torch.int64,)),
                      (rows.dest, (torch.int32,))):
        if t.device != wit.device or t.dtype not in dtypes or \
                not t.is_contiguous():
            raise ValueError(f"rows: {t.dtype} on {t.device}, witness on "
                             f"{wit.device}")
    if rows.indptr.numel() != 3 * rows.nc + 1 or \
            rows.dest.numel() != 3 * rows.nc or \
            not 0 <= rows.n_short <= 3 * rows.nc:
        raise ValueError(f"rows: {rows.indptr.numel()} offsets, "
                         f"{rows.dest.numel()} places, {rows.n_short} short "
                         f"rows for {rows.nc} constraints")
    out = torch.empty((3, m, 4), dtype=torch.int64, device=wit.device)
    kernels.R1CS.launch(
        wit.device.index, rows.indptr.data_ptr(), rows.wires.data_ptr(),
        rows.cidx.data_ptr(), rows.cidx.element_size(),
        rows.coefs.data_ptr(), wit.data_ptr(), rows.dest.data_ptr(),
        rows.n_short, rows.nc, m, n_pub, out.data_ptr(),
        stream=_stream(wit.device))
    return out
