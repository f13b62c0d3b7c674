"""The check of one proof: the eSTARK verifier, written from the protocol,
and the commitments of the inputs worked out again.

`commit_root` is the root of the tree over a column buffer's coset
extension: the reference's own commitment of the constants (the proof's
verification key) and of a trace (the proof's stage-1 root).  `verify`
replays the transcript, checks C(xi) = Q(xi) (xi^N - 1), every opened
row against its root, the FRI polynomial at each query from those rows,
each fold, and the last polynomial's degree; given the trace's own
extension, each opened stage-1 row against the trace's row there.  It
returns the checks that failed, none for a valid proof.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import field as F
from . import merkle, tensor_gl
from .air import Point
from .layout import Layout
from .transcript import Transcript

STAGES = ("1", "2", "3", "4")


def extension(buf: np.ndarray, nbits: int, nbits_ext: int,
              device: torch.device) -> torch.Tensor:
    """The coset extension [2^nbits_ext, w] of buf [2^nbits, w] (uint64)."""
    return tensor_gl.lde(tensor_gl.from_u64(buf).to(device), nbits,
                         nbits_ext)


def commit_root(buf: np.ndarray, nbits: int, nbits_ext: int,
                device: torch.device) -> list:
    """The root over the coset extension of buf [2^nbits, w] (uint64)."""
    return merkle.root(extension(buf, nbits, nbits_ext, device))


def rows_of(ext: torch.Tensor):
    """The rows of an extension at given indices, as lists of ints."""
    def rows(idx: list) -> list:
        sel = ext[torch.tensor(idx, dtype=torch.int64, device=ext.device)]
        return [[int(v) % (1 << 64) for v in r] for r in sel.cpu().tolist()]
    return rows


def publics_of(pil_json: dict, trace: np.ndarray) -> list:
    """The public inputs a trace gives: the values of committed columns at
    the rows the PIL names."""
    out = []
    for p in pil_json["publics"]:
        if p["polType"] != "cmP":
            raise NotImplementedError(f"public of {p['polType']}")
        out.append(int(trace[p["idx"], p["polId"]]) % F.P)
    return out


def _ints(xs) -> list:
    return [int(x) for x in xs]


def _rows3(flat) -> list:
    v = _ints(flat)
    return [tuple(v[i : i + 3]) for i in range(0, len(v), 3)]


def _interpolate_at(vals: list, pt) -> tuple:
    """The polynomial p of degree < n = len(vals) with p(w_n^j) = vals[j],
    evaluated at pt (GF(p^3))."""
    n = len(vals)
    if n == 1:
        return vals[0]
    bits = n.bit_length() - 1
    wi = F.inv(F.root_of_unity(bits))
    n_inv = F.inv(n)
    acc, ptk = F.ZERO3, F.ONE3
    for k in range(n):
        ck = F.ZERO3
        wik = pow(wi, k, F.P)
        wkj = 1
        for j in range(n):
            ck = F.add3(ck, F.scale3(vals[j], wkj))
            wkj = wkj * wik % F.P
        acc = F.add3(acc, F.mul3(F.scale3(ck, n_inv), ptk))
        ptk = F.mul3(ptk, pt)
    return acc


def _coefficients(vals: list) -> list:
    n = len(vals)
    bits = n.bit_length() - 1
    wi = F.inv(F.root_of_unity(bits))
    n_inv = F.inv(n)
    out = []
    for k in range(n):
        ck = F.ZERO3
        for j in range(n):
            ck = F.add3(ck, F.scale3(vals[j], pow(wi, j * k, F.P)))
        out.append(F.scale3(ck, n_inv))
    return out


def verify(proof_json: str, lay: Layout, struct: dict, const_root: list,
           publics: list, trace_rows=None) -> list:
    """The failed checks of one proof (an empty list for a valid one).
    `trace_rows(indices)`, where given, gives the trace's extension rows
    that the stage-1 openings have to equal."""
    try:
        return _verify(json.loads(proof_json), lay, struct, const_root,
                       publics, trace_rows)
    except (KeyError, IndexError, TypeError, ValueError,
            ZeroDivisionError) as e:
        return [f"malformed proof: {type(e).__name__}: {e}"]


def _verify(pf: dict, lay: Layout, struct: dict, const_root: list,
            publics: list, trace_rows) -> list:
    bad = []
    nbits, ext_bits = struct["nBits"], struct["nBitsExt"]
    steps = [s["nBits"] for s in struct["steps"]]
    n_q = struct["nQueries"]
    if _ints(pf["publics"]) != publics:
        bad.append("publics")
    roots = {s: _ints(pf[f"root{s}"]) for s in STAGES}
    evals = [F.e3(_ints(e)) for e in pf["evals"]]
    if len(evals) != len(lay.openings):
        return bad + [f"{len(evals)} openings, {len(lay.openings)} due"]

    tr = Transcript()
    tr.put(publics)
    ch = {}
    tr.put(roots["1"])
    ch["u"], ch["defVal"] = tr.draw3(), tr.draw3()
    tr.put(roots["2"])
    ch["gamma"], ch["beta"] = tr.draw3(), tr.draw3()
    tr.put(roots["3"])
    ch["vc"] = tr.draw3()
    tr.put(roots["4"])
    xi = ch["xi"] = tr.draw3()
    for e in evals:
        tr.put(e)
    ch["vf1"], ch["vf2"] = tr.draw3(), tr.draw3()

    # the constraint polynomial at xi against the quotient's pieces
    pub3 = [F.e3(p) for p in publics]

    def opened(kind, i, prime):
        return evals[lay.index[(kind, i, prime)]]
    n = 1 << nbits
    xn = F.pow3(xi, n)
    q = F.ZERO3
    for k, c in enumerate(lay.qs):
        q = F.add3(q, F.mul3(opened("cm", c, False), F.pow3(xn, k)))
    c_xi = Point(lay.air, opened, lay.im, pub3, ch).c()
    if c_xi != F.mul3(q, F.sub3(xn, F.ONE3)):
        bad.append("C(xi) != Q(xi) Z(xi)")

    # FRI: challenges, then the queries
    special = []
    for si in range(len(steps)):
        special.append(tr.draw3())
        if si < len(steps) - 1:
            tr.put(_ints(pf[f"s{si + 1}_root"]))
        else:
            for e in pf["finalPol"]:
                tr.put(_ints(e))
    last = [F.e3(_ints(e)) for e in pf["finalPol"]]
    if len(last) != 1 << steps[-1]:
        return bad + ["finalPol length"]
    ys = tr.indices(n_q, steps[0])
    if steps[0] != ext_bits:
        return bad + ["the first FRI step is not the extended domain"]

    w_ext = F.root_of_unity(ext_bits)
    wxi = F.scale3(xi, F.root_of_unity(nbits))
    vf1, vf2 = ch["vf1"], ch["vf2"]
    trees = {s: pf.get(f"s0_vals{s}") for s in STAGES + ("C",)}
    sibs = {s: pf.get(f"s0_siblings{s}") for s in STAGES + ("C",)}
    for s in STAGES + ("C",):
        if trees[s] is None or len(trees[s]) != n_q or len(sibs[s]) != n_q:
            return bad + [f"stage {s} openings of {n_q} queries"]
    roots["C"] = const_root
    if trace_rows is not None and [_ints(r) for r in trees["1"]] != \
            trace_rows(ys):
        bad.append("stage-1 rows are not the trace's")

    def fri_value(i: int, y: int):
        """The FRI polynomial at query i's point, from its opened rows."""
        val = {}
        for s, lay_row in zip(STAGES, lay.rows):
            row = _ints(trees[s][i])
            width = sum(d for _, _, d in lay_row)
            if len(row) != width:
                raise ValueError(f"stage {s} row of {len(row)}, not {width}")
            for c, off, d in lay_row:
                val[("cm", c)] = F.e3(row[off : off + d])
        consts = _ints(trees["C"][i])
        for j, v in enumerate(consts):
            val[("const", j)] = F.e3(v)
        x = F.e3(F.SHIFT * pow(w_ext, y, F.P))
        acc = None
        for c in range(lay.n_cm):
            acc = val[("cm", c)] if acc is None else F.add3(
                F.mul3(vf1, acc), val[("cm", c)])
        parts = {False: None, True: None}
        for k, (kind, pid, prime) in enumerate(lay.openings):
            t = F.sub3(val[(kind, pid)], evals[k])
            a = parts[prime]
            parts[prime] = t if a is None else F.add3(F.mul3(a, vf2), t)
        for prime, at in ((False, xi), (True, wxi)):
            if parts[prime] is None:
                continue
            term = F.mul3(parts[prime], F.mul3(x, F.inv3(F.sub3(x, at))))
            acc = F.add3(F.mul3(vf1, acc), term)
        return acc

    bad_paths = bad_folds = 0
    cur = list(ys)
    pol_bits, shift = ext_bits, F.SHIFT
    for si, nb in enumerate(steps):
        red = pol_bits - nb
        for i in range(n_q):
            y = cur[i]
            if si == 0:
                for s in STAGES + ("C",):
                    if merkle.root_of_path(_ints(trees[s][i]), y,
                                           sibs[s][i]) != roots[s]:
                        bad_paths += 1
                group = [fri_value(i, y)]
            else:
                row = _ints(pf[f"s{si}_vals"][i])
                if merkle.root_of_path(row, y, pf[f"s{si}_siblings"][i]) \
                        != _ints(pf[f"s{si}_root"]):
                    bad_paths += 1
                group = _rows3(row)
            if len(group) != 1 << red:
                return bad + [f"step {si}: a group of {len(group)}"]
            sinv = F.inv(shift * pow(F.root_of_unity(pol_bits), y, F.P) % F.P)
            v = _interpolate_at(group, F.scale3(special[si], sinv))
            if si < len(steps) - 1:
                nxt = _rows3(pf[f"s{si + 1}_vals"][i])
                if v != nxt[y >> steps[si + 1]]:
                    bad_folds += 1
            elif v != last[y]:
                bad_folds += 1
        pol_bits = nb
        shift = pow(shift, 1 << red, F.P)
        if si < len(steps) - 1:
            cur = [y % (1 << steps[si + 1]) for y in cur]
    if bad_paths:
        bad.append(f"{bad_paths} Merkle paths")
    if bad_folds:
        bad.append(f"{bad_folds} FRI values")
    # the last polynomial's degree: below 2^(nbits) / 2^(ext_bits - last)
    blow = ext_bits - nbits
    max_deg = 1 << (pol_bits - blow) if pol_bits >= blow else 1
    if any(c != F.ZERO3 for c in _coefficients(last)[max_deg:]):
        bad.append("finalPol degree")
    return bad
