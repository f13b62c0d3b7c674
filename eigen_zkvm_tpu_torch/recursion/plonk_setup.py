"""Compressor-12 setup: pack plonk gates + custom gates into the 12-column
trace, build the constant polynomials (gate selectors, S connection pols,
Lagrange publics rows) and the s_map witness scatter.

Behavioral port of recursion/src/compressor12/plonk_setup.rs, taking the
native circuit (recursion/circuit.py) instead of a circom .r1cs file.
Unlike the reference (which sizes the trace from a row-count estimate,
plonk_setup.rs:187-196), rows are packed first and the domain is sized from
the actual row count — the greedy two-halves packing can exceed the estimate
when same-constant gates don't interleave.

Port of eigen_zkvm_tpu/recursion/plonk_setup.py: the same packing and
columns; the S columns' powers are the port's field ops on CPU tensors, and
the connection cycles are swapped on Python lists.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gl
from ..stark.polsarray import PolsArray
from ..stark.starkinfo import get_ks
from . import compressor12_pil
from .circuit import CircuitBuilder, _poseidon_tables
from .r1cs2plonk import PlonkAdd, r1cs2plonk

P = 0xFFFFFFFF00000001

# constant-column layout per row: C[0..12), then the six selectors
_SEL = {"GATE": 12, "POSEIDON12": 13, "PARTIAL": 14, "CMULADD": 15,
        "EVPOL4": 16, "FFT4": 17}
_ROW_W = 18


class PlonkSetup:
    """pil + const_pols + s_map + plonk additions for one circuit shape."""

    def __init__(self, circuit: CircuitBuilder, force_n_bits: int = 0):
        gates, adds, n_vars = r1cs2plonk(circuit.constraints, circuit.n_vars)
        self.plonk_additions = adds
        n_publics = circuit.n_publics
        n_public_rows = (n_publics - 1) // 12 + 1 if n_publics else 1

        rows_c, rows_s = _pack(n_publics, n_public_rows, gates,
                               circuit.custom_gates)
        self.n_used = len(rows_s)
        n_bits = max((self.n_used - 1).bit_length(), 2)
        if force_n_bits:
            assert (1 << force_n_bits) >= self.n_used
            n_bits = force_n_bits
        self.n_bits = n_bits
        self.n_publics = n_publics

        self.pil = compressor12_pil.render(n_bits, n_publics)
        self.s_map = np.array(rows_s, dtype=np.uint64).T.copy()  # [12, n_used]
        self.const_pols = _build_const_pols(
            self.pil, n_bits, n_public_rows, rows_c, self.s_map, self.n_used)

    @classmethod
    def from_exec(cls, pil, adds, s_map) -> "PlonkSetup":
        """The part exec_witness reads, from a .exec file's additions and
        s_map (compressor12.read_exec_file) and the setup's PIL; no
        constants."""
        self = cls.__new__(cls)
        self.pil = pil
        self.plonk_additions = [PlonkAdd(*(int(x) for x in a)) for a in adds]
        self.s_map = s_map
        self.n_used = s_map.shape[1]
        self.n_bits = pil.references["Compressor.a"].polDeg.bit_length() - 1
        self.n_publics = len(pil.publics)
        self.const_pols = None
        return self


def _pack(n_publics, n_public_rows, gates, custom_gates):
    """Greedy row packing (plonk_setup.rs:229-379).  Returns per-row constant
    blocks [_ROW_W] and s_map rows [12]."""
    rows_c: list[list[int]] = []
    rows_s: list[list[int]] = []

    def new_row():
        rows_c.append([0] * _ROW_W)
        rows_s.append([0] * 12)
        return len(rows_s) - 1

    for i in range(n_public_rows):
        new_row()
    for i in range(n_publics):
        rows_s[i // 12][i % 12] = 1 + i

    partial_rows: dict[str, list] = {}
    half_rows: list[list] = []
    for g in gates:
        k = g.str_key()
        pr = partial_rows.get(k)
        if pr is not None:
            row, used = pr
            rows_s[row][used * 3 : used * 3 + 3] = list(g.s)
            pr[1] += 1
            if pr[1] == 2:
                half_rows.append(pr)
                del partial_rows[k]
            elif pr[1] == 4:
                del partial_rows[k]
        elif half_rows:
            pr = half_rows.pop(0)
            row = pr[0]
            for ci, v in zip((9, 6, 7, 8, 10, 11), g.q + (0,)):
                rows_c[row][ci] = v
            rows_s[row][pr[1] * 3 : pr[1] * 3 + 3] = list(g.s)
            pr[1] += 1
            partial_rows[k] = pr
        else:
            r = new_row()
            for ci, v in zip((3, 0, 1, 2, 4, 5), g.q + (0,)):
                rows_c[r][ci] = v
            rows_c[r][_SEL["GATE"]] = 1
            rows_s[r][0:3] = list(g.s)
            partial_rows[k] = [r, 1]

    for pr in partial_rows.values():
        row, used = pr
        if used == 1:
            rows_s[row][3:6] = rows_s[row][0:3]
            pr[1] += 1
            half_rows.append(pr)
        elif used == 3:
            rows_s[row][9:12] = rows_s[row][6:9]
        else:
            raise RuntimeError("bad partial row state")
    for row, _ in half_rows:
        rows_s[row][6:12] = [0] * 6
        for ci in (9, 6, 7, 8, 10, 11):
            rows_c[row][ci] = 0

    CP, _ = _poseidon_tables()
    for entry in custom_gates:
        name, sigs = entry[0], entry[1]
        if name == "Poseidon12":
            assert len(sigs) == 31 * 12
            for j in range(31):
                r = new_row()
                rows_s[r][:] = sigs[j * 12 : (j + 1) * 12]
                rows_c[r][0:12] = CP[j]
                rows_c[r][_SEL["POSEIDON12"]] = 1 if j < 30 else 0
                rows_c[r][_SEL["PARTIAL"]] = 1 if (4 <= j < 26) else 0
        elif name == "CMulAdd":
            assert len(sigs) == 12
            r = new_row()
            rows_s[r][:] = sigs
            rows_c[r][_SEL["CMULADD"]] = 1
            rows_c[r][9] = 1
            rows_c[r][10] = 1
        elif name == "EvPol4":
            assert len(sigs) == 21
            r = new_row()
            rows_s[r][:] = sigs[:12]
            rows_c[r][_SEL["EVPOL4"]] = 1
            r = new_row()
            rows_s[r][0:9] = sigs[12:21]
        elif name == "FFT4":
            assert len(sigs) == 24
            consts = entry[2]
            r = new_row()
            rows_s[r][:] = sigs[:12]
            rows_c[r][0:9] = [int(c) % P for c in consts]
            rows_c[r][_SEL["FFT4"]] = 1
            r = new_row()                 # output row (next of the gate row)
            rows_s[r][:] = sigs[12:24]
        else:
            raise ValueError(name)
    return rows_c, rows_s


def _build_const_pols(pil, n_bits, n_public_rows, rows_c, s_map, n_used):
    N = 1 << n_bits
    const_pols = PolsArray(pil, PolsArray.CONSTANT)
    buf = const_pols.buffer  # [N, nConst] zero-initialized
    c_ref = pil.references["Compressor.C"].id

    rc = np.array(rows_c, dtype=np.uint64)  # [n_used, 18]
    buf[:n_used, c_ref : c_ref + 12] = rc[:, 0:12]
    for name, col in _SEL.items():
        ref = pil.references[f"Compressor.{name}"].id
        buf[:n_used, ref] = rc[:, col]

    # S connection polynomials: k_j * w^i, swapped along each signal's cycle
    ks = get_ks(11)
    s_ref = pil.references["Compressor.S"].id
    w_pows = gl.powers(gl.root_of_unity(n_bits), N)   # CPU, log-doubling
    s_cols = torch.stack(
        [w_pows] + [gl.mul(w_pows, gl.as_i64(k)) for k in ks], dim=1)
    buf[:, s_ref : s_ref + 12] = gl.to_u64(s_cols)

    s_rows = buf[:n_used, s_ref : s_ref + 12].tolist()
    last_sig: dict[int, tuple] = {}
    for i, sigs in enumerate(s_map.T.tolist()):
        for j, key in enumerate(sigs):
            if key == 0:
                continue
            ls = last_sig.get(key)
            if ls is not None:
                lj, li = ls
                s_rows[li][lj], s_rows[i][j] = s_rows[i][j], s_rows[li][lj]
            else:
                last_sig[key] = (j, i)
    buf[:n_used, s_ref : s_ref + 12] = np.array(s_rows, dtype=np.uint64)

    # Lagrange rows for publics
    for i in range(n_public_rows):
        l_ref = pil.references[f"Global.L{i + 1}"].id
        buf[i, l_ref] = 1

    return const_pols


def exec_witness(circuit: CircuitBuilder, setup: PlonkSetup) -> PolsArray:
    """Scatter the circuit witness into the 12 commit columns
    (reference: compressor12_exec.rs exec())."""
    w = list(circuit.w)
    for add in setup.plonk_additions:
        w.append((w[add.s1] * add.c1 + w[add.s2] * add.c2) % P)

    cm_pols = PolsArray(setup.pil, PolsArray.COMMIT)
    a_ref = setup.pil.references["Compressor.a"].id
    warr = np.array(w, dtype=np.uint64)
    n_used = setup.s_map.shape[1]
    vals = warr[setup.s_map]          # [12, n_used]
    vals[setup.s_map == 0] = 0        # signal 0 scatters as zero
    cm_pols.buffer[:n_used, a_ref : a_ref + 12] = vals.T
    return cm_pols
