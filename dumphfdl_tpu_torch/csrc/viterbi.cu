// K1: 64-state K=7 rate-1/2 Viterbi decoder (Karn viterbi27 conventions).
//
// Replaces the TPU kernel dumphfdl_tpu/ops/fec_pallas.py:_acs_kernel (and
// its separate lax.scan chainback in _viterbi_decode_pallas).
//
// What bounds it on the H100: the chain of dependent steps, not bytes or
// operations.  An event block is 64 padded frames in each of the 8 modes,
// under 3 MB of chips and bits in all (0.001 ms at the card's memory
// rate), but a frame is a chain of up to 7560 dependent add-compare-select
// steps followed by a traceback, and only 512 warps exist to run them.  The
// design makes the longest frame's chain the whole cost, and that chain
// short:
// * one launch for all modes.  The launcher takes up to kMaxGroups groups
//   (pointer, frame count, frame length), longest frames first, and every
//   block finds its group and frame from blockIdx; the event block then
//   costs what its longest frame costs, not the sum over the modes;
// * one warp per frame, lane k owning the butterfly pair of states
//   (k, k+32), int32 path metrics in registers (exact), the butterfly
//   interleave new[2k] = even[k], new[2k+1] = odd[k] done with four warp
//   shuffles, and the 64 decision bits of a step packed by two
//   __ballot_sync into 8 bytes of shared memory (60 KB for the longest
//   frame), so the decisions never touch device memory;
// * the frame's chips are copied into shared memory once, 8 bytes a lane,
//   before the loop, and the loop reads four steps' chips with one
//   shared-memory load: no device-memory read inside the dependent chain;
// * traceback by all 32 lanes.  Lane i walks segment i of the decisions
//   backwards from a guessed state: it starts kMerge steps beyond its
//   segment in state 0 and walks down, and since survivor paths merge
//   within a few constraint lengths it reaches its segment in the true
//   state with high probability.  The lanes then compare each segment's
//   start state with the end state of the segment after it; the highest
//   lane that disagrees walks again from the right state, until none
//   disagrees.  The last segment starts in the true state (0), so the
//   result is exact whatever the guesses: at worst the lanes take turns;
// * the bits are staged in shared memory (over the chips, which are spent)
//   and written out as coalesced rows.
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
constexpr int kMaxGroups = 16;
constexpr int kMerge = 96;     // steps a lane walks to find its start state

struct Groups {
  const uint8_t* soft[kMaxGroups];   // (batch, 2*nbits) chips
  int8_t* out[kMaxGroups];           // (batch, nbits) bits
  int nbits[kMaxGroups];
  int first[kMaxGroups + 1];         // first block of each group
  int count;
};

// one traceback step: the decision of `state` at step t, and the state
// before it
__device__ __forceinline__ int back(const uint2* dec, int t, int& state) {
  const uint2 w = dec[t];
  const unsigned word = (state & 1) ? w.y : w.x;
  const int k = (word >> (state >> 1)) & 1;
  state = (state >> 1) | (k << 5);
  return k;
}

__global__ void __launch_bounds__(32) viterbi27_kernel(const Groups g) {
  extern __shared__ uint2 dec[];        // per step: x = even-state bits, y = odd
  const int lane = threadIdx.x;
  int grp = 0;
  while (grp + 1 < g.count && (int)blockIdx.x >= g.first[grp + 1]) ++grp;
  const int nbits = g.nbits[grp];
  const int frame = blockIdx.x - g.first[grp];
  const uint8_t* s = g.soft[grp] + (size_t)frame * 2 * nbits;
  int8_t* o = g.out[grp] + (size_t)frame * nbits;
  uint8_t* chips = (uint8_t*)(dec + nbits);   // 8-byte aligned, padded to 8

  // ---- chips into shared memory ----
  const int nchip = 2 * nbits;
  if ((((uintptr_t)s) & 7) == 0 && (nchip & 7) == 0) {
    for (int i = lane; i < nchip / 8; i += 32)
      ((uint2*)chips)[i] = ((const uint2*)s)[i];
  } else {
    for (int i = lane; i < nchip; i += 32) chips[i] = s[i];
  }
  __syncwarp();

  // ---- forward: add-compare-select ----
  const int b0 = (__popc((2 * lane) & kPolyA) & 1) * 255;
  const int b1 = (__popc((2 * lane) & kPolyB) & 1) * 255;
  int lo = lane == 0 ? 0 : 63;          // metric of state lane
  int hi = 63;                          // metric of state lane + 32
  const int src = lane >> 1;
  const bool odd_lane = lane & 1;
  auto step = [&](int t, int s0, int s1) {
    const int bm = abs(b0 - s0) + abs(b1 - s1);
    const int m0e = lo + bm, m1e = hi + 510 - bm;
    const bool de = m0e > m1e;          // feeds the ballot only
    const int even = min(m0e, m1e);     // -> new state 2*lane
    const int m0o = lo + 510 - bm, m1o = hi + bm;
    const bool dd = m0o > m1o;
    const int odd = min(m0o, m1o);      // -> new state 2*lane + 1
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
  };
  const int quads = nbits / 4;
  for (int q = 0; q < quads; ++q) {
    const uint2 c = ((const uint2*)chips)[q];     // chips of four steps
    step(4 * q, c.x & 255, (c.x >> 8) & 255);
    step(4 * q + 1, (c.x >> 16) & 255, c.x >> 24);
    step(4 * q + 2, c.y & 255, (c.y >> 8) & 255);
    step(4 * q + 3, (c.y >> 16) & 255, c.y >> 24);
  }
  for (int t = 4 * quads; t < nbits; ++t) step(t, chips[2 * t], chips[2 * t + 1]);
  __syncwarp();

  // ---- traceback, a segment per lane ----
  // step t (6 <= t < nbits) gives bit t - 6; the state past the last step
  // is 0.  Lane i owns steps [lo_t, hi_t).
  int8_t* bits = (int8_t*)chips;
  const int seg = (nbits - 6 + 31) / 32;
  const int lo_t = 6 + lane * seg;
  const int hi_t = min(nbits, lo_t + seg);
  const bool owns = lo_t < nbits;
  int start = 0;                        // state past step hi_t - 1
  if (owns)
    for (int t = min(nbits, hi_t + kMerge) - 1; t >= hi_t; --t)
      back(dec, t, start);
  int end = 0;                          // state before step lo_t
  bool walk = owns;
  for (;;) {
    if (walk) {
      end = start;
      for (int t = hi_t - 1; t >= lo_t; --t)
        bits[t - 6] = (int8_t)back(dec, t, end);
    }
    // a lane without steps stands for the state past the end, 0
    const int next_end = __shfl_down_sync(kFull, end, 1);
    const bool wrong = lane < 31 && owns && start != next_end;
    const unsigned m = __ballot_sync(kFull, wrong);
    if (!m) break;
    // every lane above the highest wrong one agrees with the true end, so
    // its end state is true: that lane walks again from it
    walk = lane == 31 - __clz(m);
    if (walk) start = next_end;
  }
  __syncwarp();
  for (int n = lane; n < nbits; n += 32) o[n] = n < nbits - 6 ? bits[n] : 0;
}

// shared memory of a block: 8 bytes of decisions and 2 bytes of chips per
// step (the chips padded to a multiple of 8 bytes)
size_t smem_bytes(int nbits) {
  return (size_t)nbits * sizeof(uint2) + (((size_t)2 * nbits + 7) & ~(size_t)7);
}

int launch(const Groups& g, int max_nbits, cudaStream_t stream) {
  const size_t smem = smem_bytes(max_nbits);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi27_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  viterbi27_kernel<<<g.first[g.count], 32, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// soft: (batch, 2*nbits) uint8; out: (batch, nbits) int8.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int hfdl_viterbi(const void* soft, void* out, int batch, int nbits,
                            void* stream) {
  if (batch <= 0 || nbits <= 6) return (int)cudaErrorInvalidValue;
  Groups g = {};
  g.soft[0] = (const uint8_t*)soft;
  g.out[0] = (int8_t*)out;
  g.nbits[0] = nbits;
  g.first[1] = batch;
  g.count = 1;
  return launch(g, nbits, (cudaStream_t)stream);
}

// Several batches of different frame lengths in one launch: group i is
// soft[i] (batch[i], 2*nbits[i]) uint8 -> out[i] (batch[i], nbits[i]) int8.
// The caller orders the groups longest frames first, so that the longest
// chains start first.  Returns the cudaError_t of the launch.
extern "C" int hfdl_viterbi_many(const void* const* soft, void* const* out,
                                 const int* batch, const int* nbits,
                                 int count, void* stream) {
  if (count <= 0 || count > kMaxGroups) return (int)cudaErrorInvalidValue;
  Groups g = {};
  int max_nbits = 0;
  for (int i = 0; i < count; ++i) {
    if (batch[i] <= 0 || nbits[i] <= 6) return (int)cudaErrorInvalidValue;
    g.soft[i] = (const uint8_t*)soft[i];
    g.out[i] = (int8_t*)out[i];
    g.nbits[i] = nbits[i];
    g.first[i + 1] = g.first[i] + batch[i];
    if (nbits[i] > max_nbits) max_nbits = nbits[i];
  }
  g.count = count;
  return launch(g, max_nbits, (cudaStream_t)stream);
}

extern "C" const char* hfdl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
