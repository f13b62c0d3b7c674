// K1, the MSM (msm.cuh): msm_digits (every curve's entries) and BN254 G1
// (curve 1, coordinates in Fq, W = 4 words; entries msm_*).  Replaces the
// JAX package's device MSM, eigen_zkvm_tpu/ops/ec_jax.py::_msm_core (:154)
// with its _tree_reduce (:127), and the host Pippenger of
// native/ec_curves.cpp that groth16.py calls for G1 and G2; msm.cuh
// describes the stages and what bounds them.
#include "msm.cuh"

extern "C" int msm_digits(int device, const void* points, int words,
                          const void* scalars, long long n, int c, int n_win,
                          void* keys, void* refs, void* count, void* stream) {
  return digits_entry(device, points, words, scalars, n, c, n_win, keys, refs,
                      count, stream);
}

MSM_LEVEL_ENTRIES(msm, bn254::Fq, 1)
MSM_SUMS_ENTRIES(msm, bn254::Fq, 1)
