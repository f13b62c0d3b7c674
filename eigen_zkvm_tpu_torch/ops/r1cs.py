"""R1CS evaluation over BN254's Fr: A*w, B*w and C*w for Groth16's quotient
(kernel 4, csrc/r1cs.cu).

Port of the sparse evaluation of eigen_zkvm_tpu/groth16/groth16.py
(`_r1cs_csr`, `_witness_h`).  Each matrix is CSR: `indptr` [rows + 1], the
wire of each nonzero, and the index of its coefficient in a table of the
distinct coefficients in Montgomery form (a circuit reuses a handful of
values, 1, -1 and gate constants, millions of times), built once per
constraint list.  The witness is [n_vars, 4] Montgomery words; a row's value
is the sum of coefficient * witness over its nonzeros, in Montgomery form.

A CUDA tensor goes to the kernel (one thread a row); the plain version
multiplies every nonzero, sums each row's products in 32-bit limbs with
`index_add_` and reduces the sums mod r.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from . import bigint as bi
from .bigint import FR


@dataclass
class Matrix:
    indptr: torch.Tensor   # [rows + 1] int64
    wires: torch.Tensor    # [nnz] int64
    cidx: torch.Tensor     # [nnz] int64, into coefs
    coefs: torch.Tensor    # [distinct, 4] Montgomery words

    @property
    def rows(self) -> int:
        return self.indptr.numel() - 1


def build(constraints, device) -> list[Matrix]:
    """The three CSR matrices of a list of ({wire: coef},) * 3 rows."""
    r = FR.modulus
    uniq: dict = {}
    host = []
    for sel in range(3):
        indptr = np.empty(len(constraints) + 1, dtype=np.int64)
        indptr[0] = 0
        wires, cidx = [], []
        for j, row in enumerate(constraints):
            for s, c in row[sel].items():
                wires.append(s)
                cidx.append(uniq.setdefault(c % r, len(uniq)))
            indptr[j + 1] = len(wires)
        host.append((indptr, np.asarray(wires, dtype=np.int64),
                     np.asarray(cidx, dtype=np.int64)))
    coefs = bi.mont_ints(FR, list(uniq), device)
    return [Matrix(torch.from_numpy(p).to(device),
                   torch.from_numpy(w).to(device),
                   torch.from_numpy(c).to(device), coefs)
            for p, w, c in host]


def evaluate_plain(mat: Matrix, wit: torch.Tensor) -> torch.Tensor:
    """Plain version of r1cs_eval: [rows, 4] Montgomery words."""
    lens = mat.indptr.diff()
    row = torch.repeat_interleave(
        torch.arange(mat.rows, device=wit.device), lens)
    prod = bi.mul(FR, bi.limbs(mat.coefs[mat.cidx]),
                  bi.limbs(wit[mat.wires]))
    acc = torch.zeros((mat.rows, bi.NLIMB), dtype=torch.int64,
                      device=wit.device)
    acc.index_add_(0, row, prod)
    # a row sums fewer than 2^k values below r: two more limbs hold it
    # exactly, and k conditional subtractions of r * 2^j bring it below r
    k = max(1, int(lens.max()).bit_length()) if mat.rows else 1
    x = bi._norm(F.pad(acc, (0, 2)))
    for j in range(k - 1, -1, -1):
        d, borrow = bi._sub_wrap(x, bi.const(FR.modulus << j, x.device,
                                             bi.NLIMB + 2))
        x = bi.select(borrow, x, d)
    return bi.words(x[..., : bi.NLIMB])


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def evaluate(mat: Matrix, wit: torch.Tensor) -> torch.Tensor:
    """Each row's sum of coefficient * witness: kernel 4 for a CUDA
    tensor."""
    if wit.dtype != torch.int64 or wit.dim() != 2 or wit.shape[1] != 4:
        raise ValueError(f"witness: int64 [n, 4], got {tuple(wit.shape)}")
    wit = wit.contiguous()
    if wit.device.type == "cpu":
        return evaluate_plain(mat, wit)
    return _evaluate_cuda(mat, wit)


def _evaluate_cuda(mat: Matrix, wit: torch.Tensor) -> torch.Tensor:
    out = torch.empty((mat.rows, 4), dtype=torch.int64, device=wit.device)
    if mat.rows:
        kernels.R1CS.launch(wit.device.index, mat.indptr.data_ptr(),
                            mat.wires.data_ptr(), mat.cidx.data_ptr(),
                            mat.coefs.data_ptr(), wit.data_ptr(), mat.rows,
                            out.data_ptr(), stream=_stream(wit.device))
    return out
