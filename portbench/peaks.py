"""The peaks a roofline share divides by: one NVIDIA H100 SXM (H100 80GB
HBM3) at its full 700 W, from NVIDIA's data sheet and architecture
whitepaper."""

# HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds a second: 132 SMs x 64 INT32 lanes at the
# 1,980 MHz boost clock.  A Goldilocks product needs four 32 x 32 -> 64-bit
# products (IMAD.WIDE.U32), none of which issues faster than this.
IMAD_PER_S = 132 * 64 * 1.98e9
# IMADs counted for one Goldilocks product (the reduction mod
# p = 2^64 - 2^32 + 1 takes shifts and adds, no product)
IMAD_PER_GL_MUL = 4


def least_seconds(imads: float, nbytes: float) -> float:
    """The least time the chip could take for a kernel call that does
    `imads` products and reads and writes `nbytes` once each."""
    return max(imads / IMAD_PER_S, nbytes / HBM_BYTES_PER_S)
