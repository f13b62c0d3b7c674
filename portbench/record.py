"""What one run hands the metric readers (metrics/<name>.py): each reader is
`read(run: Run) -> float | None`, None where it finds nothing to read."""
from __future__ import annotations

from dataclasses import dataclass, field

from .trace import Window


@dataclass
class Shapes:
    """The sizes one proof of a circuit works at, from the reference's
    layout (reference/layout.py): rows 2^nbits, extended 2^nbits_ext,
    each committed stage's width in base elements (cm1 .. cm4), the
    quotient's dim and degree, and the FRI steps' nBits."""
    nbits: int
    nbits_ext: int
    widths: dict
    q_dim: int
    q_deg: int
    steps: list

    @staticmethod
    def of(lay, struct_json: dict) -> "Shapes":
        widths = {f"cm{k + 1}": sum(d for _, _, d in row)
                  for k, row in enumerate(lay.rows)}
        q_dim = lay.rows[3][0][2] if lay.rows[3] else 0
        return Shapes(struct_json["nBits"], struct_json["nBitsExt"],
                      widths, q_dim, lay.q_deg,
                      [s["nBits"] for s in struct_json["steps"]])


@dataclass
class Run:
    setup_s: float
    window_s: float
    proofs: int                 # proofs completed in the window
    peak_bytes: int
    shapes: Shapes
    ticks: list = field(default_factory=list)  # per proof [(stage, s)]
    window: Window | None = None                 # traced runs only

    def mean_tick(self, stage: str) -> float | None:
        """The stage tick's mean seconds over the window's proofs; None
        when a proof lacks it (the tick was renamed) or nothing ticked."""
        vals = [dict(t).get(stage) for t in self.ticks]
        if not vals or any(v is None for v in vals):
            return None
        return sum(vals) / len(vals)
