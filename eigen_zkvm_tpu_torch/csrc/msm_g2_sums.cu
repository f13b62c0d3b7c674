// K1, the MSM (msm.cuh), over BN254 G2 (curve 2): the running sums and the
// combine (entries msm_g2_window_chunks, msm_g2_combine), beside
// msm_g2.cu's levels in a translation unit of their own.
#include "msm.cuh"

MSM_SUMS_ENTRIES(msm_g2, bn254::Fq2, 2)
