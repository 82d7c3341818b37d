// E2FGVI-HQ's feed-forward between its two linears, on Hopper (sm_90a):
// fc1's bf16 output folded (7x7 patches, stride 3, padding 3), divided by the
// fold of ones, unfolded again, GELU (erf form) and rounded to bf16, in one
// pass from fc1's output to fc2's input.
//
//   in   (N, th*tw, C*49)  bf16, contiguous; token (ty, tx) at ty*tw + tx,
//                          its value (c, ki, kj) at c*49 + ki*7 + kj (fold's
//                          own convention)
//   out  (N, th*tw, C*49)  bf16, contiguous, the same layout
//
// Token (ty, tx)'s value (c, ki, kj) lies on pixel (3ty - 3 + ki, 3tx - 3 + kj)
// of a C x H x W map, th = (H - 1) / 3 + 1, tw = (W - 1) / 3 + 1. Each pixel
// inside the map is the float32 sum of the 4 to 9 values on it, begun at 0,
// in col2im's order (token row ascending, then token column), divided by
// their count (what the fold of ones holds), then
//   g = v * 0.5f * (1.0f + erff(v * float(M_SQRT1_2)))
// as PyTorch's GELU computes it, rounded to bf16 to nearest even. out's value
// (c, ki, kj) of a token is that pixel's g, or 0 where the pixel lies in the
// padding (unfold's zero, and gelu(0) = 0). So out is bit-equal to
//   bf16(gelu(unfold(fold(float(in)) / fold(1))))
// computed by PyTorch's col2im, division, im2col and GELU on the card. GELU
// is applied once a pixel, before the unfold copies it: the same function of
// the same float32 value.
//
// Replaces no TPU kernel: XLA fuses the JAX model's fold and unfold.
//
// What bounds it on this card: bytes. fc1's output is read once and fc2's
// input written once, 2 x 57.2 MB a frame at E2FGVI-HQ's 1080p (90 x 162
// tokens of 1960); no float32 map goes to device memory.
//
// The design: a CTA owns a strip of 16 token columns, a chunk of token rows
// and a group of 8 channels (392 bf16 a token: 49 16-byte vectors), and walks
// its rows downwards. A token row's patches span 7 pixel rows, which depend
// on 5 token rows (2 of halo above and below) and 20 token columns. Going
// down one token row brings 3 new pixel rows, which need 3 token rows, 1 of
// them new. So shared memory holds a ring of 4 token rows of the strip (3
// read, 1 in flight through cp.async) and a ring of the 7 pixel rows the
// current token row's patches cover, as bf16 GELU values. Each step: wait for
// the token row in flight, start the next one, fold the 3 new pixel rows (a
// thread a pixel column and channel: its up to 21 values loaded first, then
// summed in col2im's order), then write the token row: thread (q, v) writes
// 16-byte vector v of tokens q and q + 8 of the strip, each of its 8 values a
// load from the pixel ring, with streaming stores. The halo columns are read
// again by the neighbouring strips, mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPatch = 7, kStride = 3, kPad = 3;
constexpr int kTaps = kPatch * kPatch;     // 49 values a channel and token
constexpr int kGroup = 8;                  // channels a CTA
constexpr int kVecs = kGroup * kTaps / 8;  // 49 16-byte vectors a token and group
constexpr int kTX = 16;                    // token columns a CTA writes
constexpr int kSpan = kTX + 4;             // token columns it stages
constexpr int kPX = kStride * kTX + 4;     // pixel columns it folds
constexpr int kRing = 4;                   // token rows staged
constexpr int kPixRing = kPatch;           // pixel rows held
constexpr int kThreads = kGroup * kPX;     // 416: a folding thread a channel and column
constexpr int kLanes = 8;                  // writing threads a vector: kLanes * 49 <= 416
constexpr int kRowVals = kSpan * kVecs * 8;  // bf16 of a staged token row
constexpr int kTokBytes = kRing * kRowVals * 2;
constexpr int kSmem = kTokBytes + kPixRing * kGroup * kPX * 2;  // 68,544
constexpr float kAlpha = static_cast<float>(0.70710678118654752440);  // M_SQRT1_2

static_assert(kThreads % 32 == 0 && kLanes * kVecs <= kThreads && kTX % kLanes == 0, "");

struct Args {
  const __nv_bfloat16* in;
  __nv_bfloat16* out;
  int th, tw, h, w, groups, chunk;  // chunk: token rows a CTA writes
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2) ffn_fold_gelu(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tok = reinterpret_cast<uint4*>(smem);  // [kRing][kSpan][kVecs]
  const __nv_bfloat16* tokv = reinterpret_cast<const __nv_bfloat16*>(smem);
  __nv_bfloat16* pix = reinterpret_cast<__nv_bfloat16*>(smem + kTokBytes);  // [7][8][kPX]

  const int tx0 = blockIdx.x * kTX;
  const int r0 = blockIdx.y * a.chunk;
  const int r1 = min(r0 + a.chunk, a.th);
  const int last = min(r1 + 1, a.th - 1);  // the last token row the chunk reads
  const int frame = blockIdx.z / a.groups, g = blockIdx.z % a.groups;
  const long long hidden = static_cast<long long>(a.groups) * kGroup * kTaps;
  const long long first = static_cast<long long>(frame) * a.th * a.tw;  // the frame's token 0
  const long long slice = static_cast<long long>(g) * kGroup * kTaps;   // the group's value 0

  // token row `row` of the strip (its columns inside the grid) into the ring
  auto stage = [&](int row) {
    uint4* dst = tok + (row % kRing) * kSpan * kVecs;
    for (int i = threadIdx.x; i < kSpan * kVecs; i += kThreads) {
      const int lw = i / kVecs;
      const int col = tx0 - 2 + lw;
      if (col >= 0 && col < a.tw) {
        const __nv_bfloat16* src = a.in + (first + static_cast<long long>(row) * a.tw + col) *
                                              hidden + slice;
        cp_async16(dst + i, reinterpret_cast<const uint4*>(src) + (i - lw * kVecs));
      }
    }
  };

  // folding thread (c, lx): pixel column x of channel c; the token columns
  // whose patches cover it, ascending (col2im's bounds), and where each one's
  // value for it lies in a staged token row, less its tap row
  const int fc = threadIdx.x / kPX, lx = threadIdx.x % kPX;
  const int x = kStride * tx0 - kPad + lx;
  const bool inside = x >= 0 && x < a.w;
  const int ws = x + kPad < kPatch ? 0 : (x + kPad - kPatch) / kStride + 1;
  const int nw = inside ? min((x + kPad) / kStride + 1, a.tw) - ws : 0;  // 1 to 3
  int at[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int ww = ws + k;
    at[k] = (ww - tx0 + 2) * kVecs * 8 + fc * kTaps + x + kPad - kStride * ww;
  }

  // pixel rows 3ty+1..3ty+3 of the column into the pixel ring: GELU of the
  // normalised fold, 0 outside the map. Their token rows are ty, ty+1 (tap
  // rows 4, 1; then 5, 2) and ty, ty+1, ty+2 (6, 3, 0), those inside the
  // grid. Every value is loaded first, an absent one (a token row outside the
  // grid, a column the pixel lacks) as 0: adding +0 to a sum that is never
  // -0 leaves it as it was, so each sum keeps col2im's order and bits
  auto fold = [&](int ty) {
    bool row[3];
    const __nv_bfloat16* src[3];
#pragma unroll
    for (int hh = 0; hh < 3; ++hh) {
      row[hh] = ty + hh >= 0 && ty + hh < a.th;
      src[hh] = tokv + (ty + hh + kRing) % kRing * kRowVals;
    }
    float val[3][3][3];  // [pixel row][token row][token column]
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool col = k < nw;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        val[r][0][k] = col && row[0] ? __bfloat162float(src[0][at[k] + (4 + r) * kPatch]) : 0.f;
        val[r][1][k] = col && row[1] ? __bfloat162float(src[1][at[k] + (1 + r) * kPatch]) : 0.f;
      }
      val[2][2][k] = col && row[2] ? __bfloat162float(src[2][at[k]]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = kStride * ty + 1 + r;
      float out = 0.f;
      if (inside && p >= 0 && p < a.h) {
        float sum = 0.f;
#pragma unroll
        for (int hh = 0; hh < (r == 2 ? 3 : 2); ++hh) {
#pragma unroll
          for (int k = 0; k < 3; ++k) sum += val[r][hh][k];
        }
        const int rows = row[0] + row[1] + (r == 2 && row[2]);
        const float v = sum / static_cast<float>(rows * nw);
        out = v * 0.5f * (1.0f + erff(v * kAlpha));
      }
      pix[((p + 2 * kPixRing) % kPixRing * kGroup + fc) * kPX + lx] = __float2bfloat16_rn(out);
    }
  };

  // writing thread (q, v): vector v of the strip's tokens q and q + kLanes
  const bool writes = threadIdx.x < kLanes * kVecs;
  const int v = threadIdx.x % kVecs, q = threadIdx.x / kVecs;

  // the chunk's first token row needs pixel rows 3r0-3..3r0: the last of
  // fold(r0 - 2)'s rows and all of fold(r0 - 1)'s, from token rows r0-2..r0+1
  for (int rr = max(r0 - 2, 0); rr <= min(r0 + 1, last); ++rr) stage(rr);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  fold(r0 - 2);
  fold(r0 - 1);
  __syncthreads();
  if (r0 + 2 <= last) stage(r0 + 2);
  cp_async_commit();
  for (int ty = r0; ty < r1; ++ty) {
    // token rows ty..ty+2 have landed; the pixel ring holds rows 3ty-3..3ty
    cp_async_wait_all();
    __syncthreads();
    if (ty + 3 <= last) stage(ty + 3);
    cp_async_commit();
    fold(ty);
    __syncthreads();
    if (writes) {
      // its 8 values (c, ki, kj) in the pixel ring, for token 0 of the strip
      const int base = (kStride * ty - kPad + kPixRing) % kPixRing;  // slot of the patch's row 0
      int at_e[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = 8 * v + e;
        const int c = j / kTaps, k = j % kTaps;
        const int s = base + k / kPatch;
        at_e[e] = ((s >= kPixRing ? s - kPixRing : s) * kGroup + c) * kPX + k % kPatch;
      }
#pragma unroll
      for (int t = q; t < kTX; t += kLanes) {
        if (tx0 + t >= a.tw) break;
        uint4 raw;
        __nv_bfloat16* vals = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] = pix[at_e[e] + kStride * t];
        uint4* dst = reinterpret_cast<uint4*>(
            a.out + (first + static_cast<long long>(ty) * a.tw + tx0 + t) * hidden + slice) + v;
        __stcs(dst, raw);  // streamed: fc2 reads it from device memory, not L2
      }
    }
  }
}

}  // namespace

// chunk: token rows a CTA writes.
extern "C" int elvis_ffn_fold_gelu(const void* in, void* out, int n, int th, int tw, int h, int w,
                                   int channels, int chunk, void* stream) {
  if (n <= 0 || th <= 0 || tw <= 0) return 0;
  if (channels <= 0 || channels % kGroup != 0 || chunk <= 0 ||
      th != (h + 2 * kPad - kPatch) / kStride + 1 || tw != (w + 2 * kPad - kPatch) / kStride + 1 ||
      static_cast<long long>(n) * (channels / kGroup) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  // per call, so that every device the process uses gets the attribute
  const cudaError_t err =
      cudaFuncSetAttribute(ffn_fold_gelu, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const __nv_bfloat16*>(in), static_cast<__nv_bfloat16*>(out), th, tw,
               h, w, channels / kGroup, chunk};
  const dim3 grid((tw + kTX - 1) / kTX, (th + chunk - 1) / chunk, n * a.groups);
  ffn_fold_gelu<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
