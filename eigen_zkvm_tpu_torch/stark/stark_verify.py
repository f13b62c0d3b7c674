"""STARK verifier: transcript replay + constraint check + FRI re-fold.

Port of eigen_zkvm_tpu/stark/stark_verify.py with the one-point verifier
executor of eigen_zkvm_tpu/stark/vm.py (`execute_code_one`), GL hash only.
It replays the Fiat-Shamir schedule, runs the compiled verifier code at xi,
checks Q * Z_H == C (eSTARK eq. 30), then checks every Merkle query proof
and the FRI fold chain.  Host code on Python ints (ops/f3.py `*_int`).
"""
from __future__ import annotations

import numpy as np

from ..hash import merkle
from ..hash.transcript import TranscriptGL
from ..ops import f3, gl
from .fri import FRI
from .types import parse_pil_number


def _f3s(arr) -> list:
    """[k, 3] u64 values as int 3-tuples."""
    return [tuple(int(x) for x in row)
            for row in np.asarray(arr, dtype=np.uint64).reshape(-1, 3)]


def execute_code_one(ctx_vals: dict, code: list):
    """Run verifier code at one point; every value is an F3 3-tuple.

    ctx_vals keys: consts / tree1..4 (leaf rows), evals, publics,
    challenges (lists of 3-tuples), Z / Zp, xDivXSubXi / xDivXSubWXi."""
    tmp: dict = {}

    def extract(row, pos, dim):
        if dim == 1:
            return (int(row[pos]), 0, 0)
        return tuple(int(x) for x in row[pos : pos + 3])

    def get_ref(r):
        t = r.type_
        if t == "tmp":
            return tmp[r.id]
        if t in ("tree1", "tree2", "tree3", "tree4"):
            return extract(ctx_vals[t], r.tree_pos, r.dim)
        if t == "const":
            return (int(ctx_vals["consts"][r.id]), 0, 0)
        if t == "eval":
            return ctx_vals["evals"][r.id]
        if t == "number":
            return (parse_pil_number(r.value), 0, 0)
        if t == "public":
            return ctx_vals["publics"][r.id]
        if t == "challenge":
            return ctx_vals["challenges"][r.id]
        if t in ("xDivXSubXi", "xDivXSubWXi"):
            return ctx_vals[t]
        if t == "x":
            return ctx_vals["challenges"][7]
        if t == "Z":
            return ctx_vals["Zp" if r.prime else "Z"]
        raise ValueError(f"Invalid reference type, get: {t}")

    for ci in code:
        src = [get_ref(s) for s in ci.src]
        if ci.op == "add":
            res = f3.add_int(src[0], src[1])
        elif ci.op == "sub":
            res = f3.sub_int(src[0], src[1])
        elif ci.op == "mul":
            res = f3.mul_int(src[0], src[1])
        elif ci.op == "muladd":
            res = f3.add_int(f3.mul_int(src[0], src[1]), src[2])
        elif ci.op == "copy":
            res = src[0]
        else:
            raise ValueError(f"Invalid op: {ci.op}")
        if ci.dest.type_ != "tmp":
            raise ValueError(f"verifier code writes {ci.dest.type_}")
        tmp[ci.dest.id] = res
    return get_ref(code[-1].dest)


def stark_verify(proof, const_root, starkinfo, stark_struct, program) -> bool:
    if stark_struct.verificationHashType != "GL":
        raise NotImplementedError(
            f"verificationHashType {stark_struct.verificationHashType}")
    transcript = TranscriptGL()
    nbits = stark_struct.nBits
    N = 1 << nbits
    extend_bits = stark_struct.nBitsExt - nbits

    evals = _f3s(proof.evals)
    publics = _f3s(proof.publics)
    challenges = [f3.ZERO_INT] * 8

    def draw():
        return tuple(int(x) for x in transcript.get_field())

    for i, pub in enumerate(publics):
        dim = proof.public_dims[i] if proof.public_dims else 1
        transcript.put_elements(pub[:dim])
    transcript.put_root(proof.root1)
    challenges[0] = draw()  # u
    challenges[1] = draw()  # defVal
    transcript.put_root(proof.root2)
    challenges[2] = draw()  # gamma
    challenges[3] = draw()  # beta
    transcript.put_root(proof.root3)
    challenges[4] = draw()  # vc
    transcript.put_root(proof.root4)
    challenges[7] = draw()  # xi
    for e in evals:
        transcript.put_elements(e)
    challenges[5] = draw()  # v1
    challenges[6] = draw()  # v2

    xi = challenges[7]
    x_n = f3.exp_int(xi, N)
    Z = f3.sub_int(x_n, f3.ONE_INT)
    w_n = gl.root_of_unity(nbits)
    Zp = f3.sub_int(f3.exp_int(f3.mul_base_int(xi, w_n), N), f3.ONE_INT)

    common = {"evals": evals, "publics": publics, "challenges": challenges}
    res = execute_code_one(dict(common, Z=Z, Zp=Zp),
                           program.verifier_code.first)
    x_acc, q = f3.ONE_INT, f3.ZERO_INT
    for i in range(starkinfo.q_deg):
        ev_i = starkinfo.ev_idx.get("cm", 0, starkinfo.qs[i])
        q = f3.add_int(q, f3.mul_int(x_acc, evals[ev_i]))
        x_acc = f3.mul_int(x_acc, x_n)
    if res != f3.mul_int(q, Z):
        return False

    roots = [proof.root1, proof.root2, proof.root3, proof.root4, const_root]
    w_full = gl.root_of_unity(nbits + extend_bits)
    wxi = f3.mul_base_int(xi, w_n)

    def check_query(query, idx):
        for qi, root in enumerate(roots):
            vals, mp = query[qi]
            if not merkle.verify_group_proof(root, mp, idx, vals):
                return None
        xx = (gl.mul_int(gl.SHIFT, gl.exp_int(w_full, idx)), 0, 0)
        ctx_q = dict(common, consts=query[4][0],
                     tree1=query[0][0], tree2=query[1][0],
                     tree3=query[2][0], tree4=query[3][0],
                     xDivXSubXi=f3.mul_int(xx, f3.inv_int(
                         f3.sub_int(xx, xi))),
                     xDivXSubWXi=f3.mul_int(xx, f3.inv_int(
                         f3.sub_int(xx, wxi))))
        return [execute_code_one(ctx_q, program.verifier_query_code.first)]

    return FRI(stark_struct).verify(transcript, proof.fri_proof, check_query)
