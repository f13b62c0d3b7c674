"""FRI over GF(p^3): the device fold chain, the query phase and the
verifier.

Port of eigen_zkvm_tpu/stark/fri.py (`_prove_device`, `_query_phase`,
`verify`; starky fri.rs semantics: fold schedule, transcript order, query
and proof layout).  The prover's folds and fold trees run on the engine's
device (ops/fri.py); per step only special_x goes up and the fold root comes
back, and the query rows return through one batched gather per tree.  The
verifier is host code on Python ints, with the small group iNTTs on CPU
tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import f3, gl, ntt
from ..ops import fri as fri_ops
from .backends import Backend


class FRIProof:
    def __init__(self, n_steps: int):
        # queries[si]: {"root": digest or None, "pol_queries": [...]}
        self.queries = [{"root": None, "pol_queries": []}
                        for _ in range(n_steps)]
        self.last = None  # u64 [n_last, 3]


def _rows(vals) -> list:
    """F3 values (array-like [k, 3] or flat [3k]) as int 3-tuples."""
    flat = [int(x) for x in np.asarray(vals, dtype=np.uint64).reshape(-1)]
    return [tuple(flat[i : i + 3]) for i in range(0, len(flat), 3)]


def _intt_rows(rows: list) -> list:
    """Inverse NTT of k = 2^b F3 values (component-wise), on the CPU."""
    t = gl.from_u64(np.array(rows, dtype=np.uint64).reshape(-1, 3))
    out = gl.to_u64(ntt.intt(t, len(rows).bit_length() - 1))
    return [tuple(int(x) for x in r) for r in out]


def _eval_pol_one(coeffs: list, x) -> tuple:
    """Horner: F3 coefficients at the F3 point x."""
    res = coeffs[-1]
    for j in range(len(coeffs) - 2, -1, -1):
        res = f3.add_int(f3.mul_int(res, x), coeffs[j])
    return res


class FRI:
    def __init__(self, stark_struct, backend: Backend):
        self.backend = backend  # the hash's trees, checks and transcript
        self.in_nbits = stark_struct.nBitsExt
        self.max_deg_nbits = stark_struct.nBits
        self.n_queries = stark_struct.nQueries
        self.steps = stark_struct.steps

    def prove(self, transcript, pol: torch.Tensor, query_pol, prefetch=None):
        """pol: [2^in_nbits, 3] F3 values on the shifted coset, on the
        device.  The fold chain stays there (fri.py::_prove_device)."""
        if pol.shape != (1 << self.in_nbits, 3):
            raise ValueError(f"FRI takes [2^{self.in_nbits}, 3], got "
                             f"{tuple(pol.shape)}")
        pol_bits = self.in_nbits
        shift_inv = gl.inv_int(gl.SHIFT)
        trees = []
        proof = FRIProof(len(self.steps))
        last = None
        for si, step in enumerate(self.steps):
            reduction_bits = pol_bits - step.nBits
            special_x = transcript.get_field()
            if si == 0:
                pol = pol[: 1 << step.nBits]
            else:
                pol = fri_ops.fold(pol, special_x, pol_bits, step.nBits,
                                   shift_inv)
            if si < len(self.steps) - 1:
                tree = fri_ops.fold_tree(pol, step.nBits,
                                         self.steps[si + 1].nBits,
                                         self.backend.tree)
                trees.append(tree)
                proof.queries[si + 1]["root"] = tree.root()
                transcript.put_root(tree.root())
            else:
                last = gl.to_u64(pol).copy()
                for e in last:
                    transcript.put_elements([int(e[0]), int(e[1]), int(e[2])])
            pol_bits = step.nBits
            for _ in range(reduction_bits):
                shift_inv = gl.mul_int(shift_inv, shift_inv)
        proof.last = last
        return self._query_phase(transcript, proof, trees, query_pol,
                                 prefetch)

    def _query_phase(self, transcript, proof, trees, query_pol, prefetch):
        ys = transcript.get_permutations(self.n_queries, self.steps[0].nBits)
        if prefetch is not None:
            prefetch(ys)
        ys_si = list(ys)
        for si in range(len(self.steps)):
            if si > 0 and hasattr(trees[si - 1], "prefetch"):
                trees[si - 1].prefetch(ys_si)
            for y in ys_si:
                if si == 0:
                    proof.queries[si]["pol_queries"].append(query_pol(y))
                else:
                    proof.queries[si]["pol_queries"].append(
                        [trees[si - 1].get_group_proof(y)])
            if si < len(self.steps) - 1:
                ys_si = [y % (1 << self.steps[si + 1].nBits) for y in ys_si]
        return proof

    def verify(self, transcript, proof: FRIProof, check_query) -> bool:
        """Replay the fold challenges, check every query's Merkle paths and
        folds, and the last polynomial's degree.  `check_query(query, idx)`
        returns step 0's F3 group values, or None to reject."""
        if len(proof.queries) != len(self.steps):
            return False
        special_x = []
        for si in range(len(self.steps)):
            special_x.append(tuple(int(x) for x in transcript.get_field()))
            if si < len(self.steps) - 1:
                transcript.put_root(proof.queries[si + 1]["root"])
            else:
                for e in proof.last:
                    transcript.put_elements([int(v) for v in e])

        ys = transcript.get_permutations(self.n_queries, self.steps[0].nBits)
        last = _rows(proof.last)
        pol_bits = self.in_nbits
        shift = gl.SHIFT
        for si, step in enumerate(self.steps):
            proof_item = proof.queries[si]
            reduction_bits = pol_bits - step.nBits
            for i in range(self.n_queries):
                if si == 0:
                    pgroup_e = check_query(proof_item["pol_queries"][i], ys[i])
                    if pgroup_e is None:
                        return False
                else:
                    vals, mp = proof_item["pol_queries"][i][0]
                    if not self.backend.merkle.verify_group_proof(
                            proof_item["root"], mp, ys[i], vals):
                        return False
                    pgroup_e = _rows(vals)
                sinv = gl.inv_int(gl.mul_int(shift, gl.exp_int(
                    gl.root_of_unity(pol_bits), ys[i])))
                ev = _eval_pol_one(_intt_rows(pgroup_e),
                                   f3.mul_base_int(special_x[si], sinv))
                if si < len(self.steps) - 1:
                    group_idx = ys[i] // (1 << self.steps[si + 1].nBits)
                    nxt = _rows(proof.queries[si + 1]["pol_queries"][i][0][0])
                    if ev != nxt[group_idx]:
                        return False
                elif ev != last[ys[i]]:
                    return False
            pol_bits = step.nBits
            for _ in range(reduction_bits):
                shift = gl.mul_int(shift, shift)
            if si < len(self.steps) - 1:
                ys = [y % (1 << self.steps[si + 1].nBits) for y in ys]

        # final degree check
        if pol_bits < self.in_nbits - self.max_deg_nbits:
            max_deg = 0
        else:
            max_deg = 1 << (pol_bits - (self.in_nbits - self.max_deg_nbits))
        return all(c == f3.ZERO_INT for c in _intt_rows(last)[max_deg + 1 :])
