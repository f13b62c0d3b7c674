"""Where a proof keeps each polynomial: the stage rows and the openings.

Which expressions become intermediate polynomials, the quotient's number
of pieces and the order of the openings are conventions of the proof's
format that follow from the PIL: the compiler of pil-stark's starkinfo
chooses them.  The layout takes those three from a copy of that compiler
(stark/starkinfo.py, each file naming its original) and derives the rest
itself; nothing else of the compiler's output (its prover and verifier
code) is read.
"""
from __future__ import annotations

from dataclasses import dataclass

from .air import Air
from .stark.starkinfo import StarkInfo
from .stark.types import PIL, StarkStruct


@dataclass
class Layout:
    air: Air
    im: dict            # expression id -> cm id of its intermediate pol
    q_deg: int
    qs: list            # cm ids of the quotient's pieces
    rows: list          # per stage tree 1-4: [(cm id, offset, dim)]
    openings: list      # [(kind, id, prime)] in the proof's order
    index: dict         # (kind, id, prime) -> position in the openings
    n_cm: int

    @classmethod
    def of(cls, pil_json: dict, struct_json: dict) -> "Layout":
        air = Air.of(pil_json)
        info = StarkInfo(PIL.from_json(pil_json),
                         StarkStruct.from_json(struct_json))
        n = air.n_cm1 + 3 * len(air.plookups)
        im = {eid: n + k for k, eid in enumerate(sorted(info.im_exps_list))}
        qs = list(range(n + len(im), n + len(im) + info.q_deg))
        if dict(info.im_exp2cm) != im or list(info.qs) != qs:
            raise ValueError("the compiler numbers the polynomials otherwise")
        for pu, mine in zip(info.pu_ctx, air.plookups):
            if (pu.h1_id, pu.h2_id, pu.z_id, pu.t_exp_id, pu.f_exp_id) != (
                    mine["h1"], mine["h2"], mine["z"], mine["t"], mine["f"]):
                raise ValueError("the compiler numbers the plookup otherwise")
        dims = {c: 1 for c in air.stages[0]}
        for pu in air.plookups:
            d = max(air.dim(air.expressions[pu["f"]]),
                    air.dim(air.expressions[pu["t"]]))
            dims[pu["h1"]] = dims[pu["h2"]] = d
            dims[pu["z"]] = 3
        for eid, c in im.items():
            dims[c] = air.dim(air.expressions[eid])
        q_dim = 1 if len(air.identities) + len(im) == 1 and air.dim(
            air.expressions[air.identities[0]]) == 1 else 3
        for c in qs:
            dims[c] = q_dim
        rows = []
        for ids in (air.stages[0], air.stages[1], air.stages[2] + list(
                im.values()), qs):
            off, row = 0, []
            for c in ids:
                row.append((c, off, dims[c]))
                off += dims[c]
            rows.append(row)
        openings = [(ev.type_, ev.id, bool(ev.prime)) for ev in info.ev_map]
        index = {o: i for i, o in enumerate(openings)}
        if len(index) != len(openings):
            raise ValueError("an opening appears twice")
        return cls(air, im, info.q_deg, qs, rows, openings, index,
                   qs[-1] + 1 if qs else n + len(im))
