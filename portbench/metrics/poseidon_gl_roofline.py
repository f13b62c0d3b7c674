"""poseidon_gl_roofline (%, device trace): the least time the chip could
take for the Poseidon-GL permutations one proof's shapes call for, over
the device time of the kernels named like PATTERN
(csrc/poseidon_gl.cu), per proof.

The permutations, whatever implements them: the Merkle trees of each
committed stage of nonzero width (2^(n+1) leaves) and of each FRI fold
layer but the last (2^next leaves of 3 * 2^(step - next) elements), as
starky's linear hash and tree lay them out: a leaf of w > 4 elements is
hashed in chunks of max(8, ceil(w/4)), each chunk by ceil(c/8) sponge
calls, the chunks' digests folded by ceil(4 chunks/8) more where there is
more than one; each tree level above the leaves takes one permutation a
node.  A permutation is counted as its Goldilocks products alone: 4 x 12
x^7 S-boxes in each of the 8 full rounds, and in each of the 22 partial
rounds one S-box and the 23 products of its sparse matrix (978 products;
the small-entry MDS and the one dense pre-matrix are not counted).  Bytes:
each call reads its 8 input elements and writes its 4-element digest.
The peaks are peaks.py's.
"""
from .. import peaks

PATTERN = "poseidon_gl_kernel"
GL_MULS_PER_PERMUTATION = 8 * 12 * 4 + 22 * (4 + 23)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def leaf_calls(w: int) -> int:
    """Sponge calls that hash one leaf of w elements."""
    if w <= 4:
        return 0
    bs = max(8, _ceil(w, 4))
    chunks = [min(bs, w - i) for i in range(0, w, bs)]
    calls = sum(_ceil(c, 8) for c in chunks if c > 4)
    if len(chunks) > 1:
        calls += _ceil(4 * len(chunks), 8)
    return calls


def node_calls(height: int) -> int:
    """Permutations that hash a tree's levels above its leaves."""
    calls, n = 0, height
    while n > 1:
        n = (n - 1) // 2 + 1
        calls += n
    return calls


def trees(sh) -> list:
    """(leaves, width) of each tree a proof commits."""
    out = [(1 << sh.nbits_ext, sh.widths[k])
           for k in ("cm1", "cm2", "cm3", "cm4") if sh.widths[k]]
    for prev, cur in zip(sh.steps, sh.steps[1:]):
        out.append((1 << cur, 3 << (prev - cur)))
    return out


def permutations(sh) -> int:
    return sum(h * leaf_calls(w) + node_calls(h) for h, w in trees(sh))


def least_seconds(sh) -> float:
    calls = permutations(sh)
    return peaks.least_seconds(
        calls * GL_MULS_PER_PERMUTATION * peaks.IMAD_PER_GL_MUL,
        calls * 12 * 8)


def read(run):
    if run.window is None or not run.proofs:
        return None
    spent = run.window.events.seconds_of(PATTERN)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run.shapes) * run.proofs / spent
