// K1: 64-state K=7 rate-1/2 Viterbi decoder (Karn viterbi27 conventions).
//
// Replaces the TPU kernel dumphfdl_tpu/ops/fec_pallas.py:_acs_kernel (and
// its separate lax.scan chainback in _viterbi_decode_pallas).
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// frame is a chain of up to 7560 dependent add-compare-select steps, and
// the main path decodes only 64 padded frames per mode at a time, so at
// most 64 warps are in flight on a 132-SM card.  The design keeps each
// step short: one warp per frame, lane k owning the butterfly pair of
// states (k, k+32), int32 path metrics in registers (exact), the butterfly
// interleave new[2k] = even[k], new[2k+1] = odd[k] done with four warp
// shuffles, and the 64 decision bits of a step packed by two __ballot_sync
// into 8 bytes of shared memory (60 KB for the longest frame).  Chainback
// then runs in the same kernel from shared memory, so the decisions never
// touch device memory.  Soft chips are read once (2 bytes per step).
//
// Exactness: metrics start at 0 (state 0) and 63 (others); the branch
// metric is |b0-s0| + |b1-s1| against the 0/255 expected chips, the
// complement 510 - bm; a survivor switches only on a strict '>' (ties
// keep the upper branch), as in dumphfdl_tpu/ops/fec.py.  Traceback
// starts in state 0 and consumes six virtual zero decisions past the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPolyA = 0x6d;
constexpr int kPolyB = 0x4f;

__global__ void __launch_bounds__(32)
viterbi27_kernel(const uint8_t* __restrict__ soft, int8_t* __restrict__ out,
                 int nbits) {
  extern __shared__ uint2 dec[];        // per step: x = even-state bits, y = odd
  const int lane = threadIdx.x;
  const uint8_t* s = soft + (size_t)blockIdx.x * 2 * nbits;
  const int b0 = (__popc((2 * lane) & kPolyA) & 1) * 255;
  const int b1 = (__popc((2 * lane) & kPolyB) & 1) * 255;
  int lo = lane == 0 ? 0 : 63;          // metric of state lane
  int hi = 63;                          // metric of state lane + 32
  const int src = lane >> 1;
  const bool odd_lane = lane & 1;
  for (int t = 0; t < nbits; ++t) {
    const int s0 = s[2 * t];
    const int s1 = s[2 * t + 1];
    const int bm = abs(b0 - s0) + abs(b1 - s1);
    const int m0e = lo + bm, m1e = hi + 510 - bm;
    const bool de = m0e > m1e;
    const int even = de ? m1e : m0e;    // -> new state 2*lane
    const int m0o = lo + 510 - bm, m1o = hi + bm;
    const bool dd = m0o > m1o;
    const int odd = dd ? m1o : m0o;     // -> new state 2*lane + 1
    const unsigned wde = __ballot_sync(kFull, de);
    const unsigned wdo = __ballot_sync(kFull, dd);
    if (lane == 0) dec[t] = make_uint2(wde, wdo);
    // new[lane] and new[lane + 32] come from lanes lane/2 and 16 + lane/2
    const int e1 = __shfl_sync(kFull, even, src);
    const int o1 = __shfl_sync(kFull, odd, src);
    const int e2 = __shfl_sync(kFull, even, src + 16);
    const int o2 = __shfl_sync(kFull, odd, src + 16);
    lo = odd_lane ? o1 : e1;
    hi = odd_lane ? o2 : e2;
  }
  __syncwarp();
  if (lane == 0) {
    int8_t* o = out + (size_t)blockIdx.x * nbits;
    for (int n = nbits - 1; n >= nbits - 6; --n) o[n] = 0;   // flush bits
    int state = 0;
    for (int n = nbits - 7; n >= 0; --n) {
      const uint2 w = dec[n + 6];
      const unsigned word = (state & 1) ? w.y : w.x;
      const int k = (word >> (state >> 1)) & 1;
      o[n] = (int8_t)k;
      state = (state >> 1) | (k << 5);
    }
  }
}

}  // namespace

// soft: (batch, 2*nbits) uint8; out: (batch, nbits) int8.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int hfdl_viterbi(const void* soft, void* out, int batch, int nbits,
                            void* stream) {
  if (batch <= 0 || nbits <= 6) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nbits * sizeof(uint2);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi27_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  viterbi27_kernel<<<batch, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)soft, (int8_t*)out, nbits);
  return (int)cudaGetLastError();
}

extern "C" const char* hfdl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
