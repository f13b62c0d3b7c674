// Multi-scalar multiplication over BN254 G1 and G2 for Hopper (sm_90a):
// Pippenger's bucket method, templated over the coordinate field.
//
// Replaces the JAX package's device MSM, eigen_zkvm_tpu/ops/ec_jax.py
// ::_msm_core (:154, a bit-plan double-and-add over every lane) with its
// butterfly _tree_reduce (:127), and the host Pippenger of
// native/ec_curves.cpp that groth16.py calls for G1 and G2.
//
// ops/ec.py runs the stages; sorting is glue in torch:
//   1. the scalars' c-bit digits, one entry per nonzero digit of a finite
//      point, sorted by bucket (window, digit) with torch.sort;
//   2. msm_sum: one thread a segment, a run of at most 32 entries of one
//      key, adds its points: affine points through the mixed addition
//      (7M + 4S), partial sums through the full one.  Runs longer than a
//      segment (a hot bucket: the digit 1 of a circuit's boolean wires holds
//      half the points) are summed again, level by level, by the same
//      entry;
//   3. the weights of the buckets, sum_d d * B_d, as sums too: bit j of the
//      digit selects the buckets whose sum is doubled j times, so msm_sum
//      runs once more over (window, bit) keys;
//   4. msm_combine: one block; thread w folds window w's bit planes
//      (V_w = sum_j 2^j T_(w,j)), thread 0 folds the windows by doubling and
//      writes the affine result.
//
// What bounds it on this card: field products (each about 400 integer
// instructions here, all on the SMs' integer pipe), then the gathers of
// step 2, 64 or 128 random bytes a point.  This first design keeps one
// thread a segment and plain CIOS; the bucket digits are unsigned and the
// partial sums stay Jacobian.
//
// Layouts (int64 words, Montgomery form): affine points [n, 2, W], Jacobian
// [n, 3, W], W = 4 (G1) or 8 (G2).
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Aff;
using bn254::Coord;
using bn254::Fq;
using bn254::Fq2;
using bn254::Jac;

constexpr int kThreads = 128;
constexpr int kMaxWindows = 64;

template <class E, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    msm_sum_kernel(const int64_t* __restrict__ pts,
                   const int64_t* __restrict__ idx,
                   const int64_t* __restrict__ start, long long n_seg,
                   int64_t* __restrict__ out) {
  constexpr int W = Coord<E>::kWords;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;
  Jac<E> acc = bn254::infinity<E>();
  const long long end = start[s + 1];
#pragma unroll 1
  for (long long j = start[s]; j < end; ++j) {
    const long long i = idx[j];
    if (AFFINE) {
      acc = bn254::add_affine(acc, bn254::load_affine<E>(pts + i * 2 * W));
    } else {
      acc = bn254::add(acc, bn254::load_jacobian<E>(pts + i * 3 * W));
    }
  }
  bn254::store_jacobian(out + s * 3 * W, acc);
}

template <class E>
__global__ void msm_combine_kernel(const int64_t* __restrict__ planes,
                                   int c, int n_win,
                                   int64_t* __restrict__ out) {
  constexpr int W = Coord<E>::kWords;
  __shared__ int64_t v[kMaxWindows * 3 * W];
  const int w = threadIdx.x;
  if (w < n_win) {
    Jac<E> acc = bn254::infinity<E>();
#pragma unroll 1
    for (int j = c - 1; j >= 0; --j) {
      acc = bn254::dbl(acc);
      acc = bn254::add(acc,
                       bn254::load_jacobian<E>(planes + (w * c + j) * 3 * W));
    }
    bn254::store_jacobian(v + w * 3 * W, acc);
  }
  __syncthreads();
  if (w != 0) return;
  Jac<E> res = bn254::infinity<E>();
#pragma unroll 1
  for (int k = n_win - 1; k >= 0; --k) {
#pragma unroll 1
    for (int b = 0; b < c; ++b) res = bn254::dbl(res);
    res = bn254::add(res, bn254::load_jacobian<E>(v + k * 3 * W));
  }
  bn254::store_affine(out, res);
}

template <class E>
int launch_sum(int affine, const void* pts, const void* idx,
               const void* start, long long n_seg, void* out,
               cudaStream_t stream) {
  const long long blocks = (n_seg + kThreads - 1) / kThreads;
  if (affine) {
    msm_sum_kernel<E, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const int64_t*)pts, (const int64_t*)idx, (const int64_t*)start,
        n_seg, (int64_t*)out);
  } else {
    msm_sum_kernel<E, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const int64_t*)pts, (const int64_t*)idx, (const int64_t*)start,
        n_seg, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// curve: 1 = G1, 2 = G2.  Segment s sums pts[idx[j]] for j in
// [start[s], start[s + 1]) into out[s] (Jacobian).
extern "C" int msm_sum(int device, int curve, int affine, const void* pts,
                       const void* idx, const void* start, long long n_seg,
                       void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_seg <= 0) return 0;
  if (curve == 1)
    return launch_sum<Fq>(affine, pts, idx, start, n_seg, out,
                          (cudaStream_t)stream);
  if (curve == 2)
    return launch_sum<Fq2>(affine, pts, idx, start, n_seg, out,
                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// planes [n_win * c] Jacobian: plane w * c + j sums the buckets of window w
// whose digit has bit j.  out: the affine result [2, W].
extern "C" int msm_combine(int device, int curve, const void* planes, int c,
                           int n_win, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_win < 1 || n_win > kMaxWindows || c < 1)
    return (int)cudaErrorInvalidValue;
  if (curve == 1) {
    msm_combine_kernel<Fq><<<1, kMaxWindows, 0, (cudaStream_t)stream>>>(
        (const int64_t*)planes, c, n_win, (int64_t*)out);
  } else if (curve == 2) {
    msm_combine_kernel<Fq2><<<1, kMaxWindows, 0, (cudaStream_t)stream>>>(
        (const int64_t*)planes, c, n_win, (int64_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
