"""ntt_roofline (%, device trace): the least time the chip could take for
the number-theoretic transforms one proof's shapes call for, over the
device time of the kernels named like PATTERN (csrc/ntt.cu's leaf kernel),
per proof.

The transforms, whatever implements them: each committed stage's coset
LDE (an inverse transform of 2^n rows, a forward one of 2^(n+1) rows from
2^n coefficient rows), the quotient split (an inverse and a forward
transform of 2^(n+1) rows), the openings' two Lagrange vectors (inverse,
2^n rows, 3 columns) and each FRI fold's group transforms (inverse, 2^r
rows for a fold by 2^r, 3 columns a group).  A transform of 2^m rows and
c columns does m 2^(m-1) c butterflies, each one Goldilocks product; it
reads its input rows and writes its output rows once.  The peaks are
peaks.py's (IMAD issue rate, HBM bandwidth).
"""
from .. import peaks

PATTERN = "ntt_leaf_kernel"


def transforms(sh) -> list:
    """(log2 rows, columns, rows read, rows written) of each transform."""
    n, ne = sh.nbits, sh.nbits_ext
    out = []
    for k in ("cm1", "cm2", "cm3"):
        w = sh.widths[k]
        if w:
            out += [(n, w, 1 << n, 1 << n), (ne, w, 1 << n, 1 << ne)]
    if sh.q_deg:
        out += [(ne, sh.q_dim, 1 << ne, 1 << ne),
                (ne, sh.q_dim * sh.q_deg, 1 << n, 1 << ne)]
    out += [(n, 3, 1 << n, 1 << n)] * 2
    for prev, cur in zip(sh.steps, sh.steps[1:]):
        r = prev - cur
        out.append((r, 3 << cur, 1 << r, 1 << r))
    return out


def least_seconds(sh) -> float:
    t = 0.0
    for m, c, rows_in, rows_out in transforms(sh):
        butterflies = m * (1 << m) // 2 * c
        t += peaks.least_seconds(butterflies * peaks.IMAD_PER_GL_MUL,
                                 8 * c * (rows_in + rows_out))
    return t


def read(run):
    if run.window is None or not run.proofs:
        return None
    spent = run.window.events.seconds_of(PATTERN)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.shapes) * run.proofs / spent
