// R1CS evaluation over BN254's Fr for Hopper (sm_90a): one of the matrices
// A, B, C of a Groth16 circuit times the witness.
//
// Replaces the sparse evaluation of eigen_zkvm_tpu/groth16/groth16.py
// ::_witness_h (:315, over the CSR of `_r1cs_csr` :283), which runs
// native/ec_curves.cpp's r1cs_eval on the host.
//
// One thread a row: the sum over the row's nonzeros of coefficient * witness,
// the coefficient read through its index in the table of distinct values (a
// circuit's rows reuse 1, -1 and a few gate constants).  What bounds it: one
// Fr product a nonzero (about 400 integer instructions) against 48 bytes
// read a nonzero (wire, coefficient index, a 32-byte witness value, gathered)
// and 40 a row (its offset, its value); the two are about even at this
// card's rates.
//
// indptr [rows + 1], wires [nnz], cidx [nnz] int64; coefs [distinct, 4] and
// wit [n_vars, 4] Montgomery words; out [rows, 4] Montgomery words.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fr;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    r1cs_kernel(const int64_t* __restrict__ indptr,
                const int64_t* __restrict__ wires,
                const int64_t* __restrict__ cidx,
                const int64_t* __restrict__ coefs,
                const int64_t* __restrict__ wit, long long rows,
                int64_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Fr acc = bn254::zero<1>();
  const long long end = indptr[r + 1];
  for (long long e = indptr[r]; e < end; ++e) {
    acc = bn254::add(acc, bn254::mul(bn254::load<1>(coefs + cidx[e] * 4),
                                     bn254::load<1>(wit + wires[e] * 4)));
  }
  bn254::store(out + r * 4, acc);
}

}  // namespace

extern "C" int r1cs_eval(int device, const void* indptr, const void* wires,
                         const void* cidx, const void* coefs, const void* wit,
                         long long rows, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  r1cs_kernel<<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0,
                (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)wires, (const int64_t*)cidx,
      (const int64_t*)coefs, (const int64_t*)wit, rows, (int64_t*)out);
  return (int)cudaGetLastError();
}
