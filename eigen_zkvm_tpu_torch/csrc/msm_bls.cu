// K1, the MSM (msm.cuh), over BLS12-381: curve 3 = G1 (coordinates in
// BLS12-381's Fq, 12 limbs, W = 6 words; entries msm_bls_*), 4 = G2 (its
// Fq2, W = 12; msm_bls_g2_*).  Replaces the host Pippenger the JAX package
// runs for this curve, native/ec_curves.cpp's MSM instance with 255-bit
// scalars (:2045), behind groth16.py::_msm (:241) and _native_ec
// (:208-218); its device MSM (ops/ec_jax.py) serves BN254 G1 only.  A
// translation unit of its own, so that nvcc compiles these instances
// beside the BN254 ones; the Fq product is a call here (bn254.cuh), so the
// four G2 kernels stay small enough for one job.
#include "msm.cuh"

MSM_LEVEL_ENTRIES(msm_bls, bn254::FqBls, 3)
MSM_SUMS_ENTRIES(msm_bls, bn254::FqBls, 3)
MSM_LEVEL_ENTRIES(msm_bls_g2, bn254::Fq2Bls, 4)
MSM_SUMS_ENTRIES(msm_bls_g2, bn254::Fq2Bls, 4)
