// Multi-scalar multiplication over BN254 G1 and G2 for Hopper (sm_90a):
// Pippenger's bucket method with signed digits, templated over the
// coordinate field.
//
// Replaces the JAX package's device MSM, eigen_zkvm_tpu/ops/ec_jax.py
// ::_msm_core (:154, a bit-plan double-and-add over every lane) with its
// butterfly _tree_reduce (:127), and the host Pippenger of
// native/ec_curves.cpp that groth16.py calls for G1 and G2.
//
// ops/ec.py runs the stages; sorting the entries is glue in torch:
//   1. msm_digits: thread i takes scalar i's signed c-bit digits, in
//      (-2^(c-1), 2^(c-1)] with a carry into the next window, and writes one
//      entry per nonzero digit if point i is finite: key (window, |digit|)
//      and the point's index with the digit's sign, int32, at places a warp
//      reserves with one atomic add; then one torch.sort by key;
//   2. msm_level: the bucket sums in load-balanced levels.  The sorted
//      entries are cut into chunks of L (at the first level as many as
//      spread them over the threads the card holds at once, so the level
//      is one wave of equal chunks); one thread a chunk walks it with
//      mixed additions (7M + 4S; a negative digit adds (x, q - y)) and, at
//      each change of key, writes the run it closed to its bucket when the
//      whole run lay in the chunk.  The run a chunk opened with, if it began
//      in the chunk before, and the run it closed with, if it goes on into
//      the next, leave as carries: two slots a chunk (key and Jacobian
//      partial; an unused slot holds infinity under the chunk's first or
//      last key, so the slots stay sorted).  The same entry sums the carries
//      (full additions) level by level until one chunk remains.  A hot bucket
//      (the digit 1 of a circuit's many boolean wires holds half the points
//      of window 0) costs what any other chunk costs;
//   3. msm_window_chunks: the buckets' weights by running sums.  Window w's
//      m = 2^(c-1) buckets are cut into chunks of s; thread (w, p) walks its
//      chunk from the top, S += B_d and T += S (two additions a bucket), and
//      writes U = T + (p s) S, the chunk's part of sum_d d B_d; msm_level sums
//      the U of each window;
//   4. msm_combine: one thread folds the windows, sum_w 2^(c w) V_w, by
//      Horner's rule (c doublings a window: the doublings of one point are
//      a chain that no split shortens) and writes the affine result.
// One host sync an MSM: the number of entries, which sizes every level.
//
// What bounds it on this card: field products (580 integer instructions
// each, kernel_probe, all on the SMs' integer pipe) in the first level of
// step 2, then the latency of step 4's chain and of the later levels; the
// gathers of step 2 read 64 or 128 random bytes a point.
//
// Layouts (int64 words, Montgomery form): affine points [n, 2, W], Jacobian
// [n, 3, W], W = 4 (G1) or 8 (G2); keys and references int32.
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

// Scalar s's window w (c bits at bit c w; c w < 255, c <= 32), unsigned.
__device__ __forceinline__ uint32_t raw_digit(const uint64_t (&s)[4], int c,
                                              int w) {
  const int o = c * w, wi = o >> 6, sh = o & 63;
  uint64_t d = s[wi] >> sh;
  if (sh + c > 64 && wi + 1 < 4) d |= s[wi + 1] << (64 - sh);
  return (uint32_t)(d & ((1ull << c) - 1));
}

// Thread i: the entries of point i (module comment, step 1); words: int64
// words of an affine point.  count: entries written so far (zeroed by the
// caller).
__global__ void __launch_bounds__(kThreads)
    msm_digits_kernel(const int64_t* __restrict__ points, int words,
                      const int64_t* __restrict__ scalars, long long n, int c,
                      int n_win, int32_t* __restrict__ keys,
                      int32_t* __restrict__ refs,
                      unsigned long long* __restrict__ count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t half = 1u << (c - 1);
  uint64_t s[4] = {0, 0, 0, 0};
  bool live = false;
  if (i < n) {
    for (int k = 0; k < words; ++k) live |= points[i * words + k] != 0;
    for (int k = 0; k < 4; ++k) s[k] = (uint64_t)scalars[i * 4 + k];
  }
  int cnt = 0;
  if (live) {
    uint32_t carry = 0;
    for (int w = 0; w < n_win; ++w) {
      const uint32_t d = raw_digit(s, c, w) + carry;
      carry = d > half;
      cnt += d != (carry << c);
    }
  }
  int incl = cnt;  // inclusive scan of the warp's counts
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  unsigned long long base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, (unsigned long long)incl);
  base = __shfl_sync(0xffffffffu, base, 31);
  if (!cnt) return;
  long long e = (long long)base + incl - cnt;
  uint32_t carry = 0;
  for (int w = 0; w < n_win; ++w) {
    const uint32_t u = raw_digit(s, c, w) + carry;
    carry = u > half;
    const int d = (int)u - (int)(carry << c);
    if (d == 0) continue;
    keys[e] = (int32_t)(w * half + (d < 0 ? -d : d) - 1);
    refs[e] = (int32_t)(i * 2 + (d < 0));
    ++e;
  }
}

// AFFINE: pts are affine points read through refs (index << 1 | negative),
// else Jacobian partials read in order.  Thread t sums entries
// [t L, min(t L + L, M)) (module comment, step 2).
template <class E, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    msm_level_kernel(const int64_t* __restrict__ pts,
                     const int32_t* __restrict__ refs,
                     const int32_t* __restrict__ keys, long long M, int L,
                     int64_t* __restrict__ sums,
                     int32_t* __restrict__ carry_keys,
                     int64_t* __restrict__ carry_pts) {
  constexpr int W = Coord<E>::kWords;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lo = t * L;
  if (lo >= M) return;
  const long long hi = lo + L < M ? lo + L : M;
  const int32_t first = keys[lo];
  const int32_t last = keys[hi - 1];
  bool open = lo > 0 && keys[lo - 1] == first;  // the first run began before
  const bool goes_on = hi < M && keys[hi] == last;
  int64_t* head = carry_pts + 2 * t * 3 * W;
  int64_t* tail = head + 3 * W;
  bool head_set = false;
  int32_t cur = first;
  Jac<E> acc = bn254::infinity<E>();
#pragma unroll 1
  for (long long j = lo; j < hi; ++j) {
    const int32_t k = keys[j];
    if (k != cur) {  // the run of cur ended at j - 1
      if (open) {
        bn254::store_jacobian(head, acc);
        head_set = true;
        open = false;
      } else if (!bn254::is_zero(acc.Z)) {
        bn254::store_jacobian(sums + (long long)cur * 3 * W, acc);
      }
      acc = bn254::infinity<E>();
      cur = k;
    }
    if (AFFINE) {
      const int32_t r = refs[j];
      Aff<E> q = bn254::load_affine<E>(pts + (long long)(r >> 1) * 2 * W);
      if (r & 1) q.y = bn254::neg(q.y);
      acc = bn254::add_affine(acc, q);
    } else {
      acc = bn254::add(acc, bn254::load_jacobian<E>(pts + j * 3 * W));
    }
  }
  bool tail_set = false;
  if (open) {  // one run over the whole chunk, begun before it
    bn254::store_jacobian(head, acc);
    head_set = true;
  } else if (goes_on) {
    bn254::store_jacobian(tail, acc);
    tail_set = true;
  } else if (!bn254::is_zero(acc.Z)) {
    bn254::store_jacobian(sums + (long long)last * 3 * W, acc);
  }
  if (!head_set) bn254::store_jacobian_zero<E>(head);
  if (!tail_set) bn254::store_jacobian_zero<E>(tail);
  carry_keys[2 * t] = first;
  carry_keys[2 * t + 1] = last;
}

// Thread (w, p) of n_win * (m / s): buckets [n_win, m] Jacobian, bucket b
// of a window the sum of its points of digit b + 1.  out[w * (m / s) + p] =
// sum over b in [p s, p s + s) of (b + 1) B_b.
template <class E>
__global__ void __launch_bounds__(kThreads)
    msm_window_chunks_kernel(const int64_t* __restrict__ buckets, int m,
                             int s, int n_win, int64_t* __restrict__ out) {
  constexpr int W = Coord<E>::kWords;
  const int chunks = m / s;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_win * chunks) return;
  const int w = (int)(t / chunks), p = (int)(t % chunks);
  const int64_t* B = buckets + ((long long)w * m + (long long)p * s) * 3 * W;
  Jac<E> S = bn254::infinity<E>(), T = bn254::infinity<E>();
#pragma unroll 1
  for (int b = s - 1; b >= 0; --b) {
    S = bn254::add(S, bn254::load_jacobian<E>(B + (long long)b * 3 * W));
    T = bn254::add(T, S);
  }
  // T = sum (b - p s + 1) B_b; add (p s) S by double-and-add
  const uint32_t k = (uint32_t)p * (uint32_t)s;
  Jac<E> R = bn254::infinity<E>();
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    R = bn254::dbl(R);
    if ((k >> bit) & 1) R = bn254::add(R, S);
  }
  bn254::store_jacobian(out + t * 3 * W, bn254::add(T, R));
}

// One thread: sum_w 2^(c w) V_w over the window sums, to affine.
template <class E>
__global__ void msm_combine_kernel(const int64_t* __restrict__ windows,
                                   int c, int n_win,
                                   int64_t* __restrict__ out) {
  constexpr int W = Coord<E>::kWords;
  Jac<E> res = bn254::infinity<E>();
#pragma unroll 1
  for (int w = n_win - 1; w >= 0; --w) {
#pragma unroll 1
    for (int b = 0; b < c; ++b) res = bn254::dbl(res);
    res = bn254::add(res, bn254::load_jacobian<E>(windows + w * 3 * W));
  }
  bn254::store_affine(out, res);
}

template <class E>
int launch_level(int affine, const void* pts, const void* refs,
                 const void* keys, long long M, int L, void* sums,
                 void* carry_keys, void* carry_pts, cudaStream_t stream) {
  const long long chunks = (M + L - 1) / L;
  const unsigned blocks = (unsigned)((chunks + kThreads - 1) / kThreads);
  if (affine) {
    msm_level_kernel<E, true><<<blocks, kThreads, 0, stream>>>(
        (const int64_t*)pts, (const int32_t*)refs, (const int32_t*)keys, M, L,
        (int64_t*)sums, (int32_t*)carry_keys, (int64_t*)carry_pts);
  } else {
    msm_level_kernel<E, false><<<blocks, kThreads, 0, stream>>>(
        (const int64_t*)pts, nullptr, (const int32_t*)keys, M, L,
        (int64_t*)sums, (int32_t*)carry_keys, (int64_t*)carry_pts);
  }
  return (int)cudaGetLastError();
}

template <class E>
int launch_window_chunks(const void* buckets, int m, int s, int n_win,
                         void* out, cudaStream_t stream) {
  const long long threads = (long long)n_win * (m / s);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  msm_window_chunks_kernel<E><<<blocks, kThreads, 0, stream>>>(
      (const int64_t*)buckets, m, s, n_win, (int64_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Entries of an MSM of n points (affine, `words` int64 words each) and
// scalars [n, 4]: keys, refs [n * n_win] int32, the count written to *count.
extern "C" int msm_digits(int device, const void* points, int words,
                          const void* scalars, long long n, int c, int n_win,
                          void* keys, void* refs, void* count, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c < 2 || c > 24 || (long long)c * (n_win - 1) >= 255 || n >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  msm_digits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)points, words, (const int64_t*)scalars, n, c, n_win,
      (int32_t*)keys, (int32_t*)refs, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

// curve: 1 = G1, 2 = G2.  One level of the bucket sums over M sorted
// entries in chunks of L: complete runs to sums[key] (Jacobian), carries to
// carry_keys / carry_pts [2 * ceil(M / L)].  affine: pts are affine points
// read through refs; else Jacobian partials, refs unused.
extern "C" int msm_level(int device, int curve, int affine, const void* pts,
                         const void* refs, const void* keys, long long M,
                         int L, void* sums, void* carry_keys, void* carry_pts,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 1)
    return launch_level<Fq>(affine, pts, refs, keys, M, L, sums, carry_keys,
                            carry_pts, s);
  if (curve == 2)
    return launch_level<Fq2>(affine, pts, refs, keys, M, L, sums, carry_keys,
                             carry_pts, s);
  return (int)cudaErrorInvalidValue;
}

// *threads: the threads of msm_level's first level (affine entries) that
// the card holds at once, so that M entries can take ceil(M / *threads) a
// thread and run in one wave.
extern "C" int msm_level_capacity(int device, int curve, int* threads) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (curve == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, msm_level_kernel<Fq, true>, kThreads, 0);
  else if (curve == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, msm_level_kernel<Fq2, true>, kThreads, 0);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  *threads = sms * (per_sm > 0 ? per_sm : 1) * kThreads;
  return 0;
}

// buckets [n_win, m] Jacobian -> out [n_win * (m / s)] Jacobian (s divides
// m).
extern "C" int msm_window_chunks(int device, int curve, const void* buckets,
                                 int m, int s, int n_win, void* out,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (s < 1 || m < s || m % s || n_win < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (curve == 1)
    return launch_window_chunks<Fq>(buckets, m, s, n_win, out, st);
  if (curve == 2)
    return launch_window_chunks<Fq2>(buckets, m, s, n_win, out, st);
  return (int)cudaErrorInvalidValue;
}

// windows [n_win] Jacobian window sums -> out: the affine result [2, W].
extern "C" int msm_combine(int device, int curve, const void* windows, int c,
                           int n_win, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_win < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (curve == 1) {
    msm_combine_kernel<Fq><<<1, 1, 0, s>>>((const int64_t*)windows, c, n_win,
                                          (int64_t*)out);
  } else if (curve == 2) {
    msm_combine_kernel<Fq2><<<1, 1, 0, s>>>((const int64_t*)windows, c, n_win,
                                           (int64_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
