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
// with both products kept in registers.
//   1. The CTA stages the (L, b, b) table and a run of `group` consecutive
//      blocks in shared memory (one tile, transformed in place).
//   2. Lane k of a sub-warp reads column k of its matrix X (stride C in
//      the tile: the channel fold) into registers and forms column k of
//      Y = T X, reading T's rows as float4 broadcasts.
//   3. Z = Y T^T needs the other lanes' columns: the sub-warp writes Y back
//      into its own slots of the tile, __syncwarp()s, and lane i reads ROW
//      i of Y. Row i of Z is then again a register product against T's
//      rows. One shared-memory transpose, no second tile.
//   4. The lanes write Z into the same slots; after a CTA barrier the tile
//      goes to global memory in the input's element order.
// Table entries are padded to b*b + 4 floats: rows stay 16-byte aligned
// for the float4 reads, and sub-warps of one warp that hold different
// levels read different banks.
//
// FP32 FMAs only (no TF32: the reference runs at full f32 precision).
// A negative level wraps once (l + L) and what is still outside [0, L) is
// clamped, as indexing the table on the host does in the reference.
// b is a template parameter (8 or 16); L <= 16 and C come at run time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int B>
__global__ void __launch_bounds__(kThreads)
block_transform_batched_kernel(const float* __restrict__ x, const float* __restrict__ table,
                               const int* __restrict__ idx, float* __restrict__ out,
                               long long m, int c, int levels, int group, int vec) {
  constexpr int kEntry = B * B + 4;      // padded floats per table entry
  constexpr int kSub = kThreads / B;     // matrices in flight per CTA
  extern __shared__ __align__(16) float smem[];
  float* s_t = smem;                     // levels * kEntry
  float* s_x = s_t + levels * kEntry;    // group * B * B * c, 16-byte aligned

  const int per = B * B * c;             // floats per block
  const long long m0 = static_cast<long long>(blockIdx.x) * group;
  const int g_n = static_cast<int>(min(static_cast<long long>(group), m - m0));
  const int n = g_n * per;               // a multiple of 64
  const float* xg = x + m0 * per;
  float* og = out + m0 * per;

  for (int e = threadIdx.x; e < levels * B * B; e += kThreads) {
    const int l = e / (B * B);
    s_t[l * kEntry + (e - l * B * B)] = table[e];
  }
  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(xg);
    float4* dst = reinterpret_cast<float4*>(s_x);
    for (int e = threadIdx.x; e < n / 4; e += kThreads) dst[e] = src[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) s_x[e] = xg[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % B;      // column in step 2, row in step 3
  const int sub = threadIdx.x / B;
  const unsigned sub_mask = ((1u << B) - 1u) << (B * ((threadIdx.x % 32) / B));
  const int mats = g_n * c;
  for (int mat = sub; mat < mats; mat += kSub) {
    const int g = mat / c;
    const int ch = mat - g * c;
    int lvl = idx[m0 + g];
    if (lvl < 0) lvl += levels;
    lvl = min(max(lvl, 0), levels - 1);
    const float* t = s_t + lvl * kEntry;
    float* xm = s_x + g * per + ch;      // element (r, k) of the matrix: xm[(r * B + k) * c]

    float v[B], acc[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = xm[(j * B + lane) * c];
    // column `lane` of Y: y[i] = sum_j T[i, j] x[j, lane]
#pragma unroll
    for (int i = 0; i < B; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < B; j += 4) {
        const float4 tv = *reinterpret_cast<const float4*>(t + i * B + j);
        a = fmaf(tv.x, v[j], a);
        a = fmaf(tv.y, v[j + 1], a);
        a = fmaf(tv.z, v[j + 2], a);
        a = fmaf(tv.w, v[j + 3], a);
      }
      acc[i] = a;
    }
#pragma unroll
    for (int i = 0; i < B; ++i) xm[(i * B + lane) * c] = acc[i];
    __syncwarp(sub_mask);
    // row `lane` of Y, then row `lane` of Z: z[l] = sum_k y[lane, k] T[l, k]
#pragma unroll
    for (int k = 0; k < B; ++k) v[k] = xm[(lane * B + k) * c];
#pragma unroll
    for (int l = 0; l < B; ++l) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < B; k += 4) {
        const float4 tv = *reinterpret_cast<const float4*>(t + l * B + k);
        a = fmaf(v[k], tv.x, a);
        a = fmaf(v[k + 1], tv.y, a);
        a = fmaf(v[k + 2], tv.z, a);
        a = fmaf(v[k + 3], tv.w, a);
      }
      acc[l] = a;
    }
#pragma unroll
    for (int l = 0; l < B; ++l) xm[(lane * B + l) * c] = acc[l];
  }
  __syncthreads();

  if (vec) {
    const float4* src = reinterpret_cast<const float4*>(s_x);
    float4* dst = reinterpret_cast<float4*>(og);
    for (int e = threadIdx.x; e < n / 4; e += kThreads) dst[e] = src[e];
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) og[e] = s_x[e];
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
  const size_t smem = (static_cast<size_t>(levels) * (b * b + 4) +
                       static_cast<size_t>(group) * b * b * c) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  // a block is a multiple of 256 bytes, so every CTA's run is 16-byte
  // aligned when the two base pointers are
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(ctas));
  if (b == 8) {
    block_transform_batched_kernel<8><<<grid, kThreads, smem, s>>>(x, table, idx, out, m, c,
                                                                   levels, group, vec);
  } else if (b == 16) {
    block_transform_batched_kernel<16><<<grid, kThreads, smem, s>>>(x, table, idx, out, m, c,
                                                                    levels, group, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
