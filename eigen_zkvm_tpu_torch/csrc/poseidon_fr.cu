// Poseidon over a big field on the card (sm_90a): BN254's scalar field or
// BLS12-381's, circomlib's "opt" schedule, any state width t = 2..17.
//
// Replaces the JAX package's host permutation of the big-field Merkle trees
// (native/poseidon_fr.cpp: posfr_hash_batch :432 over permute_scalar :143 /
// permute_v8 :254; hash/poseidon_big.py:132-169 in Python), which has no
// Pallas kernel.  The plain version is ops/poseidon_fr.py::permute_plain.
//
// inp [B, t-1, 4] and init [B, 4] are int64 words in value form (canonical,
// the u64 limbs of the JAX package's limb arrays); out [B, n_out, 4] gets
// the first n_out lanes of each permuted state.  State lane 0 is the
// capacity (init), lanes 1..t-1 the inputs.  The tables (C, M and P
// [t * t] with M[j][i] at j * t + i, the sparse S) are in Montgomery form
// in device memory, one set a width (hash/poseidon_big.py::device_tables).
// The inputs enter Montgomery form by one product with R^2 mod r, the
// outputs leave it by one product with 1.
//
// Schedule (PoseidonBig.hash_ex): add C; half - 1 full rounds (x^5 on
// every lane, add C, mix with M); one full round mixing with P; n_p partial
// rounds (x^5 on lane 0 plus its constant; new lane 0 = sum_j S_j * s_j;
// lanes k >= 1 += S * s0); half - 1 full rounds; a last full round with no
// constant add.
//
// Design: two kernels, and ops/poseidon_fr.py::plan picks one and its
// group size G from the width and the batch.
// - The group kernel (G = 2, 4, ..., 32 threads inside one warp carry a
//   permutation): thread l of the group owns the state lanes l, l + G,
//   l + 2G, ..., at most E of them, held in registers (E is a template
//   argument, 1, 2, 3 or 5, the loops over a thread's lanes unroll and
//   `k < t` guards them; t and G are run-time arguments).  A full round:
//   each thread takes x^5 (+ C) of its lanes and writes them to its
//   group's slot of shared memory (t x 32 bytes), the warp syncs, and each
//   thread forms its own lanes' rows of the mix, reading the t values back
//   (a loop of t trips, E independent products a trip).  A partial round:
//   every thread of the group computes s0 = x^5(st0) + c itself (the same
//   latency as one thread, no broadcast), its terms S_k s_k and updates
//   st_k += S_{t+k-1} s0, and the t-term sum for the new lane 0 is an
//   xor-butterfly of field adds over log2 G shuffles, which leaves st0 in
//   every thread for the next round.
// - The one-thread kernel (G = 1, any t): the first design of this
//   kernel, the state and the S-box outputs in local memory, the loops
//   rolled.
//
// What bounds it.  The function needs 8 (3t + t^2) products in its full
// rounds and n_p (2t + 2) in its partial rounds (plus t + n_out
// conversions): 5,168 at t = 17 over BN254 (n_p = 68), each at least 128
// IMAD.WIDE.U32; a CIOS product here is about 580 instructions
// (bn254.cuh), and its carry chains make each warp wait several clocks
// between instructions.  x^5 squares twice by bn254::sqr_sos (100 limb
// products, not 128).  A batch that fills the card is bound by issue and
// by how many warps an SM holds to hide those waits: the one-thread kernel
// issues the fewest instructions (a warp instruction serves 32
// permutations) and, at 54 registers with its state in local memory, holds
// 36 warps an SM; it takes the 2^17-2^21 t = 5 leaves and a 2^14 t = 17
// sponge.  (With the state in registers, or in shared memory, an SM held
// 16-20 warps and the t = 5 leaves ran 8-18 % slower on the H100: the L1
// and L2 back local memory beyond what the SM holds itself.)  A batch
// that leaves the card idle (a t = 17 tree level of a few thousand nodes
// or fewer: 64 blocks of 128 threads for 2^13 nodes on 132 SMs) is bound
// by one thread's serial chain of products: 5,236 at t = 17 on one
// thread, about 1,700 on a group of 4 and 550 on a warp, at the price of
// redundant S-boxes and idle lanes; the group kernel's lanes stay in
// registers (76-126 a thread, no stack frame).  Blocks of 64 or 32
// threads spread a small level over every SM.
#include <cstdint>

#include <cuda_runtime.h>

#include "bn254.cuh"

namespace {

using bn254::Fp;

constexpr int kMaxT = 17;
constexpr int kHalf = 4;  // half of the 8 full rounds
constexpr int kMaxThreads = 128;
// blocks of kMaxThreads an SM the group kernel's registers are set for
// (128 a thread at most; left to itself ptxas spilled the E = 3 instance)
constexpr int kMinBlocks = 4;

// R^2 mod r, plain 32-bit limbs: [0] BN254's Fr, [1] BLS12-381's Fr
__constant__ uint32_t kR2[2][bn254::N] = {
    {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u,
     0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u},
    {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu, 0x7254398fu,
     0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}};

template <int F>
__device__ __forceinline__ Fp<F> ld(const int64_t* p) {
  Fp<F> r;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r.v[i] = __ldg(q + i);
  return r;
}

template <int F>
__device__ __forceinline__ void put(uint4* s, const Fp<F>& a) {
  s[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  s[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

template <int F>
__device__ __forceinline__ Fp<F> get(const uint4* s) {
  const uint4 a = s[0], b = s[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// lane `src` of the caller's group of `width` threads (xor: lane ^ src)
template <int F>
__device__ __forceinline__ Fp<F> shfl(const Fp<F>& a, int src, int width,
                                      bool xor_) {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < bn254::N; ++i)
    r.v[i] = xor_ ? __shfl_xor_sync(0xffffffffu, a.v[i], src, width)
                  : __shfl_sync(0xffffffffu, a.v[i], src, width);
  return r;
}

// c ? a : b word by word: a select of values (a select of references
// would take their addresses and put them in local memory)
template <int F>
__device__ __forceinline__ Fp<F> sel(bool c, const Fp<F>& a,
                                     const Fp<F>& b) {
  Fp<F> r;
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

template <int F>
__device__ __forceinline__ Fp<F> pow5(const Fp<F>& x) {
  const Fp<F> x2 = bn254::sqr_sos(x);
  return bn254::mul(bn254::sqr_sos(x2), x);
}

// The thread's lanes k = lane + G e of st <- mat^T (x^5 of st, plus c when
// given): out_k = sum_j mat[j][k] s_j, the s_j exchanged through `slot`
template <int F, int E>
__device__ __forceinline__ void full_round(Fp<F> (&st)[E], uint4* slot,
                                           int lane, int G, int t,
                                           const int64_t* c,
                                           const int64_t* mat) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane + G * e;
    if (k < t) {
      Fp<F> x = pow5(st[e]);
      if (c != nullptr) x = bn254::add(x, ld<F>(c + 4 * k));
      put(slot + 2 * k, x);
    }
  }
  __syncwarp();
  Fp<F> acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = bn254::zero<F>();
#pragma unroll 1
  for (int j = 0; j < t; ++j) {
    const Fp<F> s = get<F>(slot + 2 * j);
    const int64_t* row = mat + 4 * j * t;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = lane + G * e;
      if (k < t)
        acc[e] = bn254::add(acc[e], bn254::mul(ld<F>(row + 4 * k), s));
    }
  }
  __syncwarp();  // every read of the slot done before the next round's writes
#pragma unroll
  for (int e = 0; e < E; ++e) st[e] = acc[e];
}

template <int F, int E>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    poseidon_fr_kernel(int t, int n_p, int G, const int64_t* C,
                       const int64_t* M, const int64_t* P, const int64_t* S,
                       const int64_t* inp, const int64_t* init, int64_t* out,
                       int n_out, long long B) {
  extern __shared__ uint4 smem[];  // a group's t values, 2 uint4 each
  const int lane = threadIdx.x & (G - 1);
  uint4* slot = smem + 2 * t * (threadIdx.x / G);
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  // a group past the batch computes on the last state and stores nothing:
  // every thread of a warp stays for the shuffles and __syncwarp
  const bool active = g < B;
  const long long b = active ? g : B - 1;

  Fp<F> r2;
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r2.v[i] = kR2[F - 1][i];
  Fp<F> st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane + G * e;
    st[e] = bn254::zero<F>();
    if (k < t) {
      const int64_t* src =
          k == 0 ? init + 4 * b : inp + 4 * ((t - 1) * b + k - 1);
      st[e] = bn254::add(bn254::mul(ld<F>(src), r2), ld<F>(C + 4 * k));
    }
  }

  const int64_t* cp = C + 4 * (kHalf + 1) * t;  // the partial rounds'
  const int64_t* cf = cp + 4 * n_p;             // the last full rounds'
#pragma unroll 1
  for (int r = 0; r < 2 * kHalf; ++r) {
    if (r == kHalf) {
      Fp<F> st0 = shfl(st[0], 0, G, false);  // thread 0 owns lane 0
#pragma unroll 1
      for (int q = 0; q < n_p; ++q) {
        const int64_t* s = S + 4 * (2 * t - 1) * q;
        const Fp<F> s0 = bn254::add(pow5(st0), ld<F>(cp + 4 * q));
        Fp<F> part = bn254::zero<F>();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = lane + G * e;
          if (k < t) {
            part = bn254::add(
                part, bn254::mul(ld<F>(s + 4 * k), sel(k == 0, s0, st[e])));
            if (k > 0)
              st[e] = bn254::add(
                  st[e], bn254::mul(ld<F>(s + 4 * (t + k - 1)), s0));
          }
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          if (off < G) part = bn254::add(part, shfl(part, off, G, true));
        st0 = part;
        if (lane == 0) st[0] = part;
      }
    }
    const int64_t* c = r < kHalf ? C + 4 * (r + 1) * t
                       : r < 2 * kHalf - 1 ? cf + 4 * (r - kHalf) * t
                                           : nullptr;
    full_round<F, E>(st, slot, lane, G, t, c, r == kHalf - 1 ? P : M);
  }

  if (!active) return;
  Fp<F> one = bn254::zero<F>();
  one.v[0] = 1;
  int64_t* o = out + 4 * (long long)n_out * b;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = lane + G * e;
    if (k < n_out) bn254::store(o + 4 * k, bn254::mul(st[e], one));
  }
}

// One thread a permutation (G = 1), every width in one instance: the
// first design of this kernel, kept for the batches that fill the card.
// The state and the S-box outputs are arrays of up to 17 values indexed at
// run time, so they live in the thread's local memory (ptxas: a 1,088-byte
// stack frame), and the loops stay rolled: few registers, so many warps an
// SM hide a product's carry chains, the L1 and L2 holding what the SM's
// own storage cannot.
template <int F>
__device__ __forceinline__ void thread_full_round(Fp<F>* st, Fp<F>* nx, int t,
                                                  const int64_t* c,
                                                  const int64_t* mat) {
#pragma unroll 1
  for (int i = 0; i < t; ++i) {
    Fp<F> x = pow5(st[i]);
    if (c != nullptr) x = bn254::add(x, ld<F>(c + 4 * i));
    nx[i] = x;
  }
#pragma unroll 1
  for (int i = 0; i < t; ++i) {
    Fp<F> acc = bn254::mul(ld<F>(mat + 4 * i), nx[0]);
#pragma unroll 1
    for (int j = 1; j < t; ++j)
      acc = bn254::add(acc, bn254::mul(ld<F>(mat + 4 * (j * t + i)), nx[j]));
    st[i] = acc;
  }
}

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
    poseidon_fr_thread_kernel(int t, int n_p, const int64_t* C,
                              const int64_t* M, const int64_t* P,
                              const int64_t* S, const int64_t* inp,
                              const int64_t* init, int64_t* out, int n_out,
                              long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fp<F> r2;
#pragma unroll
  for (int i = 0; i < bn254::N; ++i) r2.v[i] = kR2[F - 1][i];
  Fp<F> st[kMaxT], nx[kMaxT];
  st[0] = bn254::add(bn254::mul(ld<F>(init + 4 * b), r2), ld<F>(C));
  const int64_t* in = inp + 4 * (t - 1) * b;
#pragma unroll 1
  for (int i = 1; i < t; ++i)
    st[i] = bn254::add(bn254::mul(ld<F>(in + 4 * (i - 1)), r2),
                       ld<F>(C + 4 * i));

#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r)
    thread_full_round<F>(st, nx, t, C + 4 * (r + 1) * t, M);
  thread_full_round<F>(st, nx, t, C + 4 * kHalf * t, P);

  const int64_t* cp = C + 4 * (kHalf + 1) * t;
#pragma unroll 1
  for (int r = 0; r < n_p; ++r) {
    const int64_t* s = S + 4 * (2 * t - 1) * r;
    const Fp<F> s0 = bn254::add(pow5(st[0]), ld<F>(cp + 4 * r));
    Fp<F> acc = bn254::mul(ld<F>(s), s0);
#pragma unroll 1
    for (int j = 1; j < t; ++j)
      acc = bn254::add(acc, bn254::mul(ld<F>(s + 4 * j), st[j]));
#pragma unroll 1
    for (int k = 1; k < t; ++k)
      st[k] = bn254::add(st[k], bn254::mul(ld<F>(s + 4 * (t + k - 1)), s0));
    st[0] = acc;
  }

  const int64_t* cf = cp + 4 * n_p;
#pragma unroll 1
  for (int r = 0; r < kHalf - 1; ++r)
    thread_full_round<F>(st, nx, t, cf + 4 * r * t, M);
  thread_full_round<F>(st, nx, t, nullptr, M);

  Fp<F> one = bn254::zero<F>();
  one.v[0] = 1;
  int64_t* o = out + 4 * (long long)n_out * b;
#pragma unroll 1
  for (int i = 0; i < n_out; ++i)
    bn254::store(o + 4 * i, bn254::mul(st[i], one));
}

template <int F>
cudaError_t launch(int E, unsigned blocks, int threads, size_t smem,
                   cudaStream_t s, int t, int n_p, int G, const int64_t* c,
                   const int64_t* m, const int64_t* p, const int64_t* sp,
                   const int64_t* in, const int64_t* ini, int64_t* o,
                   int n_out, long long B) {
#define POSEIDON_FR_LAUNCH(EE)                                             \
  poseidon_fr_kernel<F, EE><<<blocks, threads, smem, s>>>(                 \
      t, n_p, G, c, m, p, sp, in, ini, o, n_out, B)
  switch (E) {
    case 0:
      poseidon_fr_thread_kernel<F><<<blocks, threads, smem, s>>>(
          t, n_p, c, m, p, sp, in, ini, o, n_out, B);
      break;
    case 1: POSEIDON_FR_LAUNCH(1); break;
    case 2: POSEIDON_FR_LAUNCH(2); break;
    case 3: POSEIDON_FR_LAUNCH(3); break;
    case 5: POSEIDON_FR_LAUNCH(5); break;
    default: return cudaErrorInvalidValue;
  }
#undef POSEIDON_FR_LAUNCH
  return cudaSuccess;
}

}  // namespace

// field: 0 BN254's Fr, 1 BLS12-381's Fr.  lanes: the threads a permutation
// (a power of two, 1..32; 1 is the one-thread kernel, more the group
// kernel, with ceil(t / lanes) <= 5); threads: a block's (32, 64 or 128).
// Every pointer is to int64 words on `device`; returns cudaGetLastError()
// after the launch.
extern "C" int poseidon_fr(int device, int field, int t, int n_p, int lanes,
                           int threads, const void* C, const void* M,
                           const void* P, const void* S, const void* inp,
                           const void* init, void* out, int n_out,
                           long long B, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int need = lanes > 0 ? (t + lanes - 1) / lanes : 0;
  // the instance: 0 the one-thread kernel, else the lanes a thread owns
  const int E = lanes == 1 ? 0 : need <= 3 ? need : 5;
  const long long per_block = threads / (lanes > 0 ? lanes : 1);
  // a group's slot of t values (the one-thread kernel has none)
  const size_t smem = lanes == 1 ? 0 : (size_t)per_block * t * 32;
  if (field < 0 || field > 1 || t < 2 || t > kMaxT || n_p < 0 || n_out < 1
      || n_out > t || B < 0 || lanes < 1 || lanes > 32
      || (lanes & (lanes - 1)) != 0 || (lanes > 1 && need > 5)
      || (threads != 32 && threads != 64 && threads != kMaxThreads))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c = (const int64_t*)C;
  const auto* m = (const int64_t*)M;
  const auto* p = (const int64_t*)P;
  const auto* sp = (const int64_t*)S;
  const auto* in = (const int64_t*)inp;
  const auto* ini = (const int64_t*)init;
  auto* o = (int64_t*)out;
  err = field == 0 ? launch<1>(E, (unsigned)blocks, threads, smem, s, t, n_p,
                               lanes, c, m, p, sp, in, ini, o, n_out, B)
                   : launch<2>(E, (unsigned)blocks, threads, smem, s, t, n_p,
                               lanes, c, m, p, sp, in, ini, o, n_out, B);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
