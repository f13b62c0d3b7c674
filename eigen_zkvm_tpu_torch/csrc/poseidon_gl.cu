// Poseidon-GL permutation (t = 12, x^7 S-box, 8 full + 22 partial rounds in
// the "opt" constant schedule) for Hopper (sm_90a), bit-exact with
// eigen_zkvm_tpu/hash/poseidon_gl.py::permute.
//
// Replaces the Pallas kernels eigen_zkvm_tpu/ops/poseidon_pallas.py::_kernel
// (VPU) and eigen_zkvm_tpu/ops/poseidon_mxu.py::_kernel (MDS layers as bf16
// matmuls), and the fused-XLA eigen_zkvm_tpu/ops/poseidon_jax.py::permute
// that the JAX prover runs by default.
//
// What bounds it on the card: the number of integer instructions.  A
// permutation moves 96 bytes in and 32 out and issues tens of thousands of
// IMAD / IADD3 / LOP3-class instructions, all on the SM's 64 integer lanes;
// with one thread per state the lanes are already mostly full, so the
// design cuts instructions rather than adding states in flight:
//   - the 12 lanes stay in registers as values merely below 2^64; only the
//     lanes that are written out are brought below p;
//   - the seven MDS layers (entries below 2^6) take each lane as two 32-bit
//     halves: 24 IMAD.WIDE.U32 and one short reduction an output lane, in
//     place of 12 field products, 12 reductions and 11 modular adds;
//   - the dense pre-partial matrix and each partial round's dot product add
//     their twelve 128-bit products in a three-word accumulator and reduce
//     once; the eleven rank-one updates add the lane into the product before
//     its reduction;
//   - every round-constant add rides in the last product of an S-box;
//   - the rounds are unrolled (the partial ones 11 at a time), so a constant
//     is an operand at an immediate offset into __constant__ memory, read
//     at one address by the whole warp;
//   - rows that are 16-byte aligned are read and written 16 bytes at a time.
//
// Entry: each of B rows reads `in_width` (8 or 12) lanes from
// in + b * in_stride; with in_width = 8 the capacity lanes come from
// cap[b * 4 .. b * 4 + 3], or are zero when cap is null.  The first
// `out_width` (4 or 12) lanes of the result go to out + b * out_stride.
#include <cstdint>

#include <cuda_runtime.h>

#include "gl.cuh"

namespace {

constexpr int T = 12;
constexpr int kPartialRounds = 22;
// Launch shape, by measurement on the H100 at 2^20 states: 128 threads with
// at least 3 blocks an SM caps a thread at 168 registers (12 warps an SM, no
// spills) and ran 1.5x faster than the 206 registers ptxas takes unasked;
// 4 blocks (128 registers) spill.  The partial rounds unrolled 11 at a time
// ran a little faster than all 22 and than a rolled loop, which spills.
constexpr int kPartialUnroll = 11;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;

__constant__ uint64_t kC[118];   // round constants, opt schedule
__constant__ uint32_t kM[144];   // MDS, out[i] = sum_j st[j] * kM[j * 12 + i]
__constant__ uint64_t kP[144];   // pre-partial-round dense matrix
__constant__ uint64_t kS[506];   // sparse partial-round rows and columns

// MDS layer on any u64 lanes: the matrix entries are small (their column
// sums times 2^32 stay below 2^64), so the low and the high half of every
// lane are summed apart and joined in one reduction.
__device__ __forceinline__ void mix_mds(uint64_t st[T]) {
  uint64_t t[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t a = 0, b = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      a += (uint64_t)gl::lo32(st[j]) * kM[j * T + i];
      b += (uint64_t)gl::hi32(st[j]) * kM[j * T + i];
    }
    gl::U128 v{a, b >> 32};   // a + b * 2^32
    gl::add128(v, b << 32);
    t[i] = gl::reduce96(v.lo, gl::lo32(v.hi));
  }
#pragma unroll
  for (int i = 0; i < T; ++i) st[i] = t[i];
}

// the dense pre-partial matrix: one three-word dot product an output lane
__device__ __forceinline__ void mix_dense(uint64_t st[T]) {
  uint64_t t[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    gl::Acc acc;
#pragma unroll
    for (int j = 0; j < T; ++j) acc.mul_add(st[j], kP[j * T + i]);
    t[i] = acc.reduce();
  }
#pragma unroll
  for (int i = 0; i < T; ++i) st[i] = t[i];
}

// S-box on every lane, the round constants at c_off added (none: c_off < 0)
__device__ __forceinline__ void sbox_all(uint64_t st[T], int c_off) {
#pragma unroll
  for (int i = 0; i < T; ++i)
    st[i] = gl::pow7_add_nc(st[i], c_off < 0 ? 0 : kC[c_off + i]);
}

__device__ __forceinline__ void permute(uint64_t st[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i) st[i] = gl::add_nc(st[i], kC[i]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    sbox_all(st, (r + 1) * T);
    mix_mds(st);
  }
  sbox_all(st, 4 * T);
  mix_dense(st);
#pragma unroll kPartialUnroll
  for (int r = 0; r < kPartialRounds; ++r) {
    const int base = (2 * T - 1) * r;
    const uint64_t s0 = gl::pow7_add_nc(st[0], kC[5 * T + r]);
    gl::Acc acc;
    acc.mul_add(s0, kS[base]);
#pragma unroll
    for (int j = 1; j < T; ++j) acc.mul_add(st[j], kS[base + j]);
#pragma unroll
    for (int k = 1; k < T; ++k) {
      gl::U128 p = gl::mul_wide(s0, kS[base + T - 1 + k]);
      gl::add128(p, st[k]);   // (2^64 - 1)^2 + 2^64 - 1 < 2^128
      st[k] = gl::reduce128(p.lo, p.hi);
    }
    st[0] = acc.reduce();
  }
  const int tail = 5 * T + kPartialRounds;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    sbox_all(st, tail + r * T);
    mix_mds(st);
  }
  sbox_all(st, -1);
  mix_mds(st);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
poseidon_gl_kernel(const uint64_t* in, long long in_stride, int in_width,
                   const uint64_t* cap, uint64_t* out, long long out_stride,
                   int out_width, long long B, int in_vec, int out_vec) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint64_t* row = in + b * in_stride;
  uint64_t st[T];
  if (in_vec) {
    const ulonglong2* row2 = reinterpret_cast<const ulonglong2*>(row);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const ulonglong2 v = row2[i];
      st[2 * i] = v.x;
      st[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = row[i];
  }
  if (in_width == T) {
#pragma unroll
    for (int i = 8; i < T; ++i) st[i] = row[i];
  } else if (cap != nullptr) {
#pragma unroll
    for (int i = 8; i < T; ++i) st[i] = cap[b * 4 + (i - 8)];
  } else {
#pragma unroll
    for (int i = 8; i < T; ++i) st[i] = 0;
  }
  permute(st);
  uint64_t* dst = out + b * out_stride;
#pragma unroll
  for (int i = 0; i < T; i += 2) {
    if (i >= out_width) break;
    const uint64_t x = gl::canon(st[i]), y = gl::canon(st[i + 1]);
    if (out_vec) {
      *reinterpret_cast<ulonglong2*>(dst + i) = make_ulonglong2(x, y);
    } else {
      dst[i] = x;
      dst[i + 1] = y;
    }
  }
}

}  // namespace

// Copies the constant tables to the device.  The MDS entries must be small
// enough for mix_mds (below 2^16, so twelve of them times 2^32 stay far
// below 2^64); 1 is returned (cudaErrorInvalidValue) where they are not.
extern "C" int poseidon_gl_set_constants(int device, const void* C,
                                         const void* M, const void* Pm,
                                         const void* S) {
  uint32_t m32[144];
  for (int i = 0; i < 144; ++i) {
    const uint64_t m = ((const uint64_t*)M)[i];
    if (m >> 16) return (int)cudaErrorInvalidValue;
    m32[i] = (uint32_t)m;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(kC, C, sizeof(kC));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(kM, m32, sizeof(kM));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(kP, Pm, sizeof(kP));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(kS, S, sizeof(kS));
  return (int)err;
}

extern "C" int poseidon_gl(int device, const void* in, long long in_stride,
                           int in_width, const void* cap, void* out,
                           long long out_stride, int out_width, long long B,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if ((in_width != 8 && in_width != T) || (out_width != 4 && out_width != T))
    return (int)cudaErrorInvalidValue;
  // 16-byte accesses where every row starts on a 16-byte boundary
  const int in_vec = (uintptr_t)in % 16 == 0 && in_stride % 2 == 0;
  const int out_vec = (uintptr_t)out % 16 == 0 && out_stride % 2 == 0;
  const long long blocks = (B + kThreads - 1) / kThreads;
  poseidon_gl_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, in_stride, in_width, (const uint64_t*)cap,
      (uint64_t*)out, out_stride, out_width, B, in_vec, out_vec);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
