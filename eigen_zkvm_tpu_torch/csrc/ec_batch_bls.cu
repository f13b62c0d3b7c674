// K2, the fixed-base batch (ec_batch.cuh), over BLS12-381: curve 3 = G1, 4
// = G2.  Replaces eigen_zkvm_tpu/groth16/groth16.py::_fixed_base_all (:221)
// for this curve, which runs native/ec_curves.cpp's BLS12-381 instance on
// the host.  A translation unit of its own, so that nvcc compiles these
// instances beside ec_batch.cu's.
#include "ec_batch.cuh"

extern "C" int ec_bls_fixed_base(int device, int curve, const void* table,
                                 const void* scalars, long long n, void* out,
                                 void* scratch, void* stream) {
  return fixed_base_entry<bn254::FqBls, bn254::Fq2Bls, 3, 4>(
      device, curve, table, scalars, n, out, scratch, stream);
}
