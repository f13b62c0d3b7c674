// Test entry for the field primitives of gl.cuh: applies one primitive to
// arrays of operands so that a test can hold the device arithmetic against
// Python integers on chosen edge values (random operands reach the
// reduction's rare carries with probability about 2^-32).  Not on the
// prover's path.
//
// op: 0 mul(a, b)        any u64 operands
//     1 sqr(a)           any u64
//     2 add(a, b)        canonical operands
//     3 sub(a, b)        a any u64, b canonical
//     4 mul_pow2(a, k)   any u64, 0 <= k < 192
//     5 dot: out[i] = sum_j a[i * 12 + j] * b[i * 12 + j], any u64, through
//       the three-word accumulator
//     6 add_nc(a, b)     a any u64, b canonical
//     7 pow7_add_nc(a, b) any u64
// Results are written canonical.
#include <cstdint>

#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

__global__ void gl_check_kernel(int op, const uint64_t* a, const uint64_t* b,
                                uint64_t* out, long long n, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint64_t r = 0;
  switch (op) {
    case 0: r = gl::mul(a[i], b[i]); break;
    case 1: r = gl::sqr(a[i]); break;
    case 2: r = gl::add(a[i], b[i]); break;
    case 3: r = gl::canon(gl::sub(a[i], b[i])); break;
    case 4: r = gl::mul_pow2(a[i], k); break;
    case 5: {
      gl::Acc acc;
      for (int j = 0; j < 12; ++j) acc.mul_add(a[i * 12 + j], b[i * 12 + j]);
      r = gl::canon(acc.reduce());
      break;
    }
    case 6: r = gl::canon(gl::add_nc(a[i], b[i])); break;
    case 7: r = gl::canon(gl::pow7_add_nc(a[i], b[i])); break;
  }
  out[i] = r;
}

}  // namespace

extern "C" int gl_check(int device, int op, const void* a, const void* b,
                        void* out, long long n, int k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < 0 || op > 7 || k < 0 || k >= 192)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  gl_check_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      op, (const uint64_t*)a, (const uint64_t*)b, (uint64_t*)out, n, k);
  return (int)cudaGetLastError();
}
