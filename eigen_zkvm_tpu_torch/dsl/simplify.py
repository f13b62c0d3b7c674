"""Constraint simplification for DSL-compiled circuits (circom O0/O1/O2).

The reference's circom front-end applies linear-constraint simplification
before writing the .r1cs (dsl_compile/src/input_user.rs:55
`get_simplification_style`, O1 = reduced, O2 = full).  This pass is the
native equivalent, run over a populated CircuitBuilder:

  O0 — nothing.
  O1 — eliminate pure renaming constraints (two-term linear relations
       c1*s1 + c2*s2 == 0), the "reduced simplification".
  O2 — full Gaussian elimination of every linear constraint: any
       constraint whose product side is constant becomes a linear
       equation; one free signal is solved for and substituted through
       the whole system, to a fixpoint.

Signals that must survive are never chosen as pivots: the one-wire,
publics (their R1CS positions are the verification key's interface) and
any signal referenced by a custom gate (the compressor12 pipeline reads
those by id).  The witness is compacted to the surviving signals, so the
result is a strictly smaller but equivalent R1CS + witness — smaller QAP
degree and fewer MSM points downstream in Groth16.

Port of eigen_zkvm_tpu/dsl/simplify.py (host code on Python ints,
unchanged): the same pivots, substitutions, compaction and statistics.
"""
from __future__ import annotations


def _resolve(lc: dict, subs: dict, P: int) -> dict:
    """Rewrite {sig: coef} through the substitution map (fully-resolved
    substitutions: their RHS never mentions an eliminated signal)."""
    if not any(s in subs for s in lc):
        return lc
    out: dict = {}
    for s, c in lc.items():
        c %= P
        if c == 0:
            continue
        rep = subs.get(s)
        if rep is None:
            out[s] = (out.get(s, 0) + c) % P
        else:
            for s2, c2 in rep.items():
                out[s2] = (out.get(s2, 0) + c * c2) % P
    return {s: c for s, c in out.items() if c % P}


def _is_const(lc: dict) -> bool:
    return all(s == 0 for s in lc)


def _const_of(lc: dict, P: int) -> int:
    return lc.get(0, 0) % P


def _linear_of(A: dict, B: dict, C: dict, P: int):
    """If A*B - C == 0 is linear, return its LC as {sig: coef} (== 0);
    else None.  Linear iff either product side is constant."""
    if _is_const(A):
        k = _const_of(A, P)
        lc = {s: (k * c) % P for s, c in B.items()}
    elif _is_const(B):
        k = _const_of(B, P)
        lc = {s: (k * c) % P for s, c in A.items()}
    else:
        return None
    for s, c in C.items():
        lc[s] = (lc.get(s, 0) - c) % P
    return {s: c for s, c in lc.items() if c % P}


def simplify(builder, level: int = 2) -> dict:
    """Simplify builder.constraints in place; returns stats.

    level: 0 = no-op, 1 = renames only (circom --O1 reduced style),
    2 = full linear elimination (circom default --O2).
    """
    P = builder.P
    stats = {"constraints_before": len(builder.constraints),
             "signals_before": len(builder.w)}
    if level <= 0 or not builder.constraints:
        stats["constraints_after"] = len(builder.constraints)
        stats["signals_after"] = len(builder.w)
        return stats

    protected = set([0])
    protected.update(range(1, builder.n_publics + 1))
    # custom-gate entries are (name, sigs) or (name, sigs, args/consts) —
    # parameterized `template custom` and FFT4 carry a third element
    for entry in builder.custom_gates:
        protected.update(entry[1])

    constraints = [(dict(A), dict(B), dict(C))
                   for A, B, C in builder.constraints]
    subs: dict = {}  # sig -> fully-resolved {sig: coef} (incl. key 0)

    changed = True
    while changed:
        changed = False
        kept = []
        for A, B, C in constraints:
            if subs:
                A = _resolve(A, subs, P)
                B = _resolve(B, subs, P)
                C = _resolve(C, subs, P)
            lc = _linear_of(A, B, C, P)
            if lc is None:
                kept.append((A, B, C))
                continue
            if not lc:
                continue  # trivially satisfied
            if _is_const(lc):
                raise ValueError("inconsistent constraint after "
                                 "simplification (nonzero constant == 0)")
            if level == 1 and not (len(lc) == 2 and 0 not in lc):
                kept.append((A, B, C))
                continue
            pivot = None
            for s in lc:
                if s != 0 and s not in protected:
                    pivot = s
                    break
            if pivot is None:  # all-public relation: must stay proven
                kept.append(({}, {}, lc))
                continue
            inv = pow(lc[pivot], P - 2, P)
            rep = {s: (-c * inv) % P for s, c in lc.items() if s != pivot}
            # fold into existing substitutions so every map stays resolved
            for k, v in subs.items():
                if pivot in v:
                    coef = v.pop(pivot)
                    for s2, c2 in rep.items():
                        v[s2] = (v.get(s2, 0) + coef * c2) % P
                    subs[k] = {s: c for s, c in v.items() if c}
            subs[pivot] = rep
            changed = True
        constraints = kept

    # ---- compact the witness: keep one-wire, publics, surviving signals
    live = set([0]) | set(range(1, builder.n_publics + 1))
    for A, B, C in constraints:
        live.update(A)
        live.update(B)
        live.update(C)
    for entry in builder.custom_gates:
        live.update(entry[1])
    live.discard(0)
    remap = {0: 0}
    neww = [builder.w[0]]
    for s in range(1, len(builder.w)):
        if s in live:
            remap[s] = len(neww)
            neww.append(builder.w[s])

    def rm(lc):
        return {remap[s]: c % P for s, c in lc.items() if c % P}

    builder.constraints = [(rm(A), rm(B), rm(C)) for A, B, C in constraints]
    builder.custom_gates = [
        (entry[0], [remap[s] for s in entry[1]], *entry[2:])
        for entry in builder.custom_gates]
    builder.w = neww
    builder._mat_cache = {}
    if hasattr(builder, "sym"):  # keep .sym witness indices honest
        builder.sym = [(fq, remap.get(sid, -1), ci)
                       for fq, sid, ci in builder.sym]
    stats["constraints_after"] = len(builder.constraints)
    stats["signals_after"] = len(builder.w)
    stats["eliminated"] = len(subs)
    return stats
