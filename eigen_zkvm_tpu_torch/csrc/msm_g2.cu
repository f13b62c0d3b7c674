// K1, the MSM (msm.cuh), over BN254 G2 (curve 2, coordinates in Fq2, W = 8
// words): the bucket levels (entries msm_g2_level*).  A translation unit of
// its own: the G2 instances, each a few inlined Fq2 point formulas at 255
// registers with spills, were most of msm.cu's build when they sat there.
#include "msm.cuh"

MSM_LEVEL_ENTRIES(msm_g2, bn254::Fq2, 2)
