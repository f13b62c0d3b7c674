// K2, the fixed-base batch (ec_batch.cuh), over BN254: curve 1 = G1, 2 =
// G2.  Replaces eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all (:221);
// ec_batch.cuh describes the design and what bounds it.
#include "ec_batch.cuh"

extern "C" int ec_fixed_base(int device, int curve, const void* table,
                             const void* scalars, long long n, void* out,
                             void* scratch, void* stream) {
  return fixed_base_entry<bn254::Fq, bn254::Fq2, 1, 2>(
      device, curve, table, scalars, n, out, scratch, stream);
}
