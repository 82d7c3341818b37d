// Per-block two-sided matrix transform on Hopper (sm_90a), f32, in
// batched-small-matrix form.
//
//   out[m, :, :, c] = T[idx[m]] . X[m, :, :, c] . T[idx[m]]^T
//
// Replaces the TPU kernel elvis_tpu/kernels/block_transform.py::
// apply_block_matrix_pallas (pallas_call at line 183). That kernel folds
// the channels into the block axis on the host (a transpose pass each
// way), pads the rows to a multiple of its tile, picks each matrix's
// operator with a one-hot sum over all L table entries (the TPU has no
// vector gather) and runs two batched (b, b) dot_generals. None of that
// is carried over: a thread here indexes the table by level, the channel
// fold is a stride in the shared-memory read, and the tail CTA is simply
// shorter.
//
// What bounds it on this card: bytes, as for block_transform.cu (the same
// function: each block read once and written once, 4 b^3 FLOPs per block
// and channel). So the global traffic is one coalesced 16-byte-per-thread
// load and one such store of the (M, b, b, C) layout; everything between
// them stays on the SM.
//
// Design (what makes it the batched-small kernel): the unit of work is ONE
// (b, b) matrix of one block and channel, owned by a sub-warp of b lanes,
// with both products kept in registers. The arithmetic is
// block_transform_core.cuh, shared with block_transform.cu.
//   1. The CTA stages the (L, b, b) table and a run of `group` consecutive
//      blocks in shared memory (one tile, transformed in place).
//   2. Lane k of a sub-warp reads column k of its matrix X (stride C in
//      the tile: the channel fold) into registers and forms column k of
//      Y = T X, reading T's rows as float4 broadcasts.
//   3. Z = Y T^T needs the other lanes' columns: Y goes once through the
//      sub-warp's own scratch of b rows of b + 1 floats, and lane i reads
//      ROW i of Y from there. Reading the rows back from the tile (lane
//      stride b*C floats) would be an 8-way bank conflict at b = 16, C = 3;
//      the scratch's odd pitch has none. Row i of Z is again a register
//      product against T's rows.
//   4. The lanes write Z into their matrix' slots of the tile; after a CTA
//      barrier the tile goes to global memory in the input's element order.
// Table entries are padded to b*b + 4 floats: rows stay 16-byte aligned
// for the float4 reads, and sub-warps of one warp that hold different
// levels read different banks. Each sum goes to shared memory as it is
// formed, so a lane holds b operands and one sum.
//
// FP32 FMAs only (no TF32: the reference runs at full f32 precision).
// A negative level wraps once (l + L) and what is still outside [0, L) is
// clamped, as indexing the table on the host does in the reference.
// b is a template parameter (8 or 16); L <= 16 and C come at run time.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_transform_core.cuh"

namespace {

template <int B>
__global__ void __launch_bounds__(elvis::CoreShape<B>::kThreads)
block_transform_batched_kernel(const float* __restrict__ x, const float* __restrict__ table,
                               const int* __restrict__ idx, float* __restrict__ out,
                               long long m, int c, int levels, int group, int vec) {
  using Shape = elvis::CoreShape<B>;
  constexpr int kT = Shape::kThreads;
  constexpr int kSub = Shape::kSub;      // matrices in flight per CTA
  extern __shared__ __align__(16) float smem[];
  float* s_t = smem;                                // levels * kEntry
  float* s_scr = s_t + levels * Shape::kEntry;      // kSub * kScratch
  float* s_x = s_scr + kSub * Shape::kScratch;      // group * B * B * c, 16-byte aligned

  const int per = B * B * c;             // floats per block
  const long long m0 = static_cast<long long>(blockIdx.x) * group;
  const int g_n = static_cast<int>(min(static_cast<long long>(group), m - m0));
  const int n = g_n * per;               // a multiple of 64
  const float* xg = x + m0 * per;
  float* og = out + m0 * per;

  elvis::stage_table<B>(s_t, table, levels, threadIdx.x, kT);
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(xg);
    float4* dst = reinterpret_cast<float4*>(s_x);
    for (int e = threadIdx.x; e < n / 4; e += kT) dst[e] = src[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kT) s_x[e] = xg[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % B;      // column in step 2, row in step 3
  const int sub = threadIdx.x / B;
  const unsigned sub_mask = elvis::sub_warp_mask<B>(threadIdx.x);
  float* scr = s_scr + sub * Shape::kScratch;
  const int mats = g_n * c;
  for (int mat = sub; mat < mats; mat += kSub) {
    const int g = mat / c;
    const int ch = mat - g * c;
    const int lvl = elvis::wrap_level(idx[m0 + g], levels);
    float* xm = s_x + g * per + ch;      // element (r, k) of the matrix: xm[(r * B + k) * c]
    elvis::transform_matrix<B, 1, float, float, false>(xm, B * c, xm, B * c, c,
                                                    s_t + lvl * Shape::kEntry, scr, lane,
                                                    sub_mask, 0.f);
  }
  __syncthreads();

  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(s_x);
    float4* dst = reinterpret_cast<float4*>(og);
    for (int e = threadIdx.x; e < n / 4; e += kT) dst[e] = src[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kT) og[e] = s_x[e];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: x and out (m, b, b, c)
// f32, table (levels, b, b) f32, idx (m,) int32, all contiguous on the
// current device; `group` blocks go to one CTA. Launches on `stream`, does
// not synchronise, and returns the launch's cudaGetLastError() as an int
// (0 = cudaSuccess).
extern "C" int elvis_block_transform_batched(const float* x, const float* table,
                                             const int* idx, float* out, long long m, int b,
                                             int c, int levels, int group, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > 16 || c < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = (m + group - 1) / group;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = b == 8 ? elvis::CoreShape<8>::kThreads : elvis::CoreShape<16>::kThreads;
  const size_t smem = (static_cast<size_t>(levels) * (b * b + 4) +
                       static_cast<size_t>(threads) * (b + 1) +
                       static_cast<size_t>(group) * b * b * c) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // a block is a multiple of 256 bytes, so every CTA's run is 16-byte
  // aligned when the two base pointers are
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(ctas));
  if (b == 8) {
    block_transform_batched_kernel<8><<<grid, threads, smem, s>>>(x, table, idx, out, m,
                                                                      c, levels, group, vec);
  } else if (b == 16) {
    block_transform_batched_kernel<16><<<grid, threads, smem, s>>>(x, table, idx, out, m,
                                                                        c, levels, group, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
