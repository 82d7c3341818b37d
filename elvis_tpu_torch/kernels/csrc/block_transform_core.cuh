// Arithmetic core of the per-block two-sided matrix transform on Hopper
// (sm_90a), shared by block_transform.cu and block_transform_batched.cu.
//
//   Z = T . X . T^T     for ONE (b, b) matrix X of one block and channel
//
// Both CUDA kernels replace TPU kernels of
// elvis_tpu/kernels/block_transform.py (apply_block_matrix_pallas_kron and
// apply_block_matrix_pallas); the function they share is bound by bytes on
// this card (each element read once and written once against 4 b FLOPs per
// element), so the arithmetic has to stay out of the way of the copies:
// FP32 FMAs fed from registers, no operand of an FMA read as a scalar from
// shared memory.
//
// Design: a sub-warp of b lanes owns the matrix, or the CB matrices of CB
// neighbouring channels of one block. They share their level, so one read
// of T, one look-up of the level and one pair of sub-warp barriers serve CB
// times the FMAs, and a lane has CB independent sums in flight.
//   1. Lane k reads column k of X from the staged tile (element stride
//      `cstride`, row stride `in_rs`; uint8 is converted here, on the way
//      into registers) and forms column k of Y = T X. T's rows come as
//      float4 broadcasts from a table whose entries are padded to b*b + 4
//      floats, so that sub-warps of one warp that hold different levels
//      read different banks.
//   2. Z = Y T^T needs the other lanes' columns. Y goes once through a
//      scratch of b rows of b + 1 floats that belongs to the sub-warp: the
//      column write (lane stride 1) and the row read (lane stride b + 1,
//      odd) are both free of bank conflicts, at b = 16 too. Reading the
//      rows back from the tile itself would have lane stride b*C floats: 48
//      at b = 16, C = 3, an 8-way conflict.
//   3. Lane i forms row i of Z and writes it to the output tile, which may
//      be the input tile (same type, in place). Each sum goes to shared
//      memory as soon as it is formed, so a lane holds b operands and one
//      sum, not 2 b: at b = 16 that is what keeps the register count low.
//   4. Optional affine epilogue (the unsharp mask): with amount a > 0 the
//      lane reads row i of X again and writes clip((1 + a) X - a Z, 0, 255);
//      with a <= 0 it writes X itself. The input tile must then not be the
//      output tile.
// A uint8 output is rounded half to even (as torch.round) and clipped to
// [0, 255] by one saturating conversion.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace elvis {

template <int B>
struct CoreShape {
  // Threads per CTA: 32 sub-warps of 8 lanes, or 8 sub-warps of 16. A
  // b = 16 matrix is four times the bytes of a b = 8 one, so fewer
  // sub-warps fill their trips from a tile of the same size (24 matrices
  // of a 24 KB f32 tile at C = 3: three full trips of 8 sub-warps).
  static constexpr int kThreads = B == 8 ? 256 : 128;
  static constexpr int kSub = kThreads / B;       // matrices in flight per CTA
  static constexpr int kEntry = B * B + 4;        // padded floats per table entry
  static constexpr int kScratch = B * (B + 1);    // floats of one sub-warp's Y scratch
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint8_t from_f32<uint8_t>(float v) {
  // round to nearest even, saturate to [0, 255]: clamp(round(v), 0, 255)
  unsigned r;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(r) : "f"(v));
  return static_cast<uint8_t>(r);
}

// A level as indexing the table on the host reads it in the reference: a
// negative level wraps once, what is still outside [0, levels) is clamped.
__device__ __forceinline__ int wrap_level(int l, int levels) {
  if (l < 0) l += levels;
  return min(max(l, 0), levels - 1);
}

// (levels, B, B) table in global memory -> padded entries in shared memory.
template <int B>
__device__ __forceinline__ void stage_table(float* s_t, const float* __restrict__ table,
                                            int levels, int tid, int nthreads) {
  for (int e = tid; e < levels * B * B; e += nthreads) {
    const int l = e / (B * B);
    s_t[l * CoreShape<B>::kEntry + (e - l * B * B)] = table[e];
  }
}

// Bit mask of the sub-warp of B lanes that `tid` belongs to.
template <int B>
__device__ __forceinline__ unsigned sub_warp_mask(int tid) {
  return (B == 32 ? 0xffffffffu : ((1u << B) - 1u)) << (B * ((tid % 32) / B));
}

// CB matrices: channels 0 .. CB-1 of one block. xin / xout point at element
// (0, 0) of channel 0 in the input and output tiles; element (r, k) of
// channel cc lies at r * rs + k * cstride + cc. `t` is the padded table
// entry of the block's level, `scr` the sub-warp's scratch of CB * kScratch
// floats. All lanes of the sub-warp call it together (`mask` =
// sub_warp_mask).
template <int B, int CB, typename TIn, typename TOut, bool AMOUNT>
__device__ __forceinline__ void transform_matrix(const TIn* xin, int in_rs, TOut* xout,
                                                 int out_rs, int cstride, const float* t,
                                                 float* scr, int lane, unsigned mask,
                                                 float amount) {
  constexpr int kScratch = CoreShape<B>::kScratch;
  float v[CB][B];
#pragma unroll
  for (int j = 0; j < B; ++j) {
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) v[cc][j] = to_f32(xin[j * in_rs + lane * cstride + cc]);
  }
  // column `lane` of Y: y[i] = sum_j T[i, j] x[j, lane]
#pragma unroll
  for (int i = 0; i < B; ++i) {
    float a[CB];
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) a[cc] = 0.f;
#pragma unroll
    for (int j = 0; j < B; j += 4) {
      const float4 tv = *reinterpret_cast<const float4*>(t + i * B + j);
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        a[cc] = fmaf(tv.x, v[cc][j], a[cc]);
        a[cc] = fmaf(tv.y, v[cc][j + 1], a[cc]);
        a[cc] = fmaf(tv.z, v[cc][j + 2], a[cc]);
        a[cc] = fmaf(tv.w, v[cc][j + 3], a[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) scr[cc * kScratch + i * (B + 1) + lane] = a[cc];
  }
  __syncwarp(mask);
  // row `lane` of Y
#pragma unroll
  for (int cc = 0; cc < CB; ++cc) {
#pragma unroll
    for (int k = 0; k < B; ++k) v[cc][k] = scr[cc * kScratch + lane * (B + 1) + k];
  }
  __syncwarp(mask);  // the next block's column write must not overtake this read
  // row `lane` of Z: z[l] = sum_k y[lane, k] T[l, k]
#pragma unroll
  for (int l = 0; l < B; ++l) {
    float a[CB];
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) a[cc] = 0.f;
#pragma unroll
    for (int k = 0; k < B; k += 4) {
      const float4 tv = *reinterpret_cast<const float4*>(t + l * B + k);
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        a[cc] = fmaf(v[cc][k], tv.x, a[cc]);
        a[cc] = fmaf(v[cc][k + 1], tv.y, a[cc]);
        a[cc] = fmaf(v[cc][k + 2], tv.z, a[cc]);
        a[cc] = fmaf(v[cc][k + 3], tv.w, a[cc]);
      }
    }
#pragma unroll
    for (int cc = 0; cc < CB; ++cc) {
      float z = a[cc];
      if (AMOUNT) {
        // two roundings of the products and one of the difference, as the
        // plain version computes it (no contraction into an FMA)
        const float x = to_f32(xin[lane * in_rs + l * cstride + cc]);
        const float sharp = __fsub_rn(__fmul_rn(1.f + amount, x), __fmul_rn(amount, z));
        z = amount > 0.f ? fminf(fmaxf(sharp, 0.f), 255.f) : x;
      }
      xout[lane * out_rs + l * cstride + cc] = from_f32<TOut>(z);
    }
  }
}

}  // namespace elvis
