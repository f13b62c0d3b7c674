// Micro-kernel that measures the rate at which an SM issues IMAD.WIDE.U32
// (the 32x32+64 -> 64-bit multiply-add every Goldilocks product is built
// from) and, for comparison, the 32-bit IMAD.  Each thread runs kChains
// independent accumulator chains, so the multiplier's latency is covered and
// the issue rate is what is read.  One block of 1024 threads a SM; every
// block reports the clock cycles it took, so the rate per clock does not
// depend on the SM clock the card happens to run at.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

template <bool kWide>
__global__ void __launch_bounds__(1024)
imad_probe_kernel(uint32_t b, int iters, uint64_t* sink,
                  long long* cycles) {
  uint64_t acc[kChains];
  uint32_t acc32[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    acc[k] = threadIdx.x + k;
    acc32[k] = threadIdx.x + k;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      // one multiplicand is the chain's own low word, so the product can be
      // neither hoisted out of the loop nor turned into adds
      if (kWide)
        asm volatile("{\n\t.reg .u32 l, h;\n\t"
                     "mov.b64 {l, h}, %0;\n\t"
                     "mad.wide.u32 %0, l, %1, %0;\n\t}"
                     : "+l"(acc[k]) : "r"(b));
      else
        asm volatile("mad.lo.u32 %0, %0, %1, %0;"
                     : "+r"(acc32[k]) : "r"(b));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s += acc[k] + acc32[k];
  if (s == 0x1234567ull) sink[0] = s;  // keeps the chains alive
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

// Launches `blocks` blocks of 1024 threads, each thread issuing
// imad_probe_chains() * iters multiply-adds; cycles[b] receives block b's
// clock64() span.  wide != 0 times IMAD.WIDE.U32, else the 32-bit IMAD.
extern "C" int imad_probe(int device, int wide, int blocks, int iters,
                          void* sink, void* cycles, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (wide)
    imad_probe_kernel<true><<<blocks, 1024, 0, (cudaStream_t)stream>>>(
        5u, iters, (uint64_t*)sink, (long long*)cycles);
  else
    imad_probe_kernel<false><<<blocks, 1024, 0, (cudaStream_t)stream>>>(
        5u, iters, (uint64_t*)sink, (long long*)cycles);
  return (int)cudaGetLastError();
}

extern "C" int imad_probe_chains() { return kChains; }
