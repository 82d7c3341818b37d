// The sampling half of a modulated deformable 3x3 convolution (DCNv2, mmcv's
// modulated_deform_conv2d: stride 1, padding 1, dilation 1) on Hopper
// (sm_90a): the bf16 column buffer that one GEMM against the packed weight
// turns into the convolution.
//
//   x     (N, H, W, C)       bf16, channels last; C = G * CG
//   off   (N, H, W, G*9*2)   float32; group g, tap k = 3*ky + kx: row offset
//                            at 18g + 2k, column offset at 18g + 2k + 1
//   mask  (N, H, W, G*9)     float32, tap (g, k) at 9g + k
//   cols  (N, H, W, G*9*CG)  bf16, column (g, k, c) at (9g + k)*CG + c
//
// Tap (g, k) of pixel (y, x) samples group g's CG channels at
//   py = float(y - 1 + ky) + dy,  px = float(x - 1 + kx) + dx
// bilinearly, each corner outside the frame read as zero, and nothing at
// all unless -1 < py < H and -1 < px < W (mmcv's dmcn_im2col_bilinear):
//   w1 = (1-ly)(1-lx), w2 = (1-ly)lx, w3 = ly(1-lx), w4 = ly lx
//   col = bf16(((w1 v1 + w2 v2) + w3 v3) + w4 v4) * m)
// Every float32 step is written with an explicit round-to-nearest
// intrinsic, so nothing contracts into a fused multiply-add and the columns
// are bit-equal to the plain PyTorch version (kernels/dcn.py), which runs
// the same steps as separate elementwise operations.
//
// Replaces no TPU kernel: the JAX package has no deformable convolution.
//
// What bounds it on this card: bytes. A thread owns one (pixel, group, tap):
// it reads its two offsets and its mask (12 bytes; the threads of one pixel
// and group read 108 consecutive bytes), four corners of CG bf16 channels
// (16-byte vectors; neighbouring taps hit the same lines, served by L2),
// and writes CG bf16 columns (16-byte vectors; consecutive threads write
// consecutive 2*CG-byte runs of one row of the buffer). The buffer is 9x
// the features in bytes; the GEMM reads it once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 channels in a 16-byte access

struct Args {
  const __nv_bfloat16* x;
  const float* off;
  const float* mask;
  __nv_bfloat16* cols;
  long long items;  // N*H*W*G*9
  int h, w, c, g, vecs;  // vecs: a group's channels in 16-byte vectors
};

__device__ __forceinline__ void unpack(const uint4& raw, float* v) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < kVec / 2; ++q) {
    const float2 f = __bfloat1622float2(pair[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__global__ void __launch_bounds__(kThreads) dcn_columns(Args a) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= a.items) return;
  const int k = static_cast<int>(item % 9);
  const long long pg = item / 9;  // pixel * G + group
  const int g = static_cast<int>(pg % a.g);
  const long long pix = pg / a.g;
  const int xx = static_cast<int>(pix % a.w);
  const long long row = pix / a.w;
  const int yy = static_cast<int>(row % a.h);
  const long long frame = row / a.h;
  const int ky = k / 3, kx = k - 3 * ky;

  const float2 d = *reinterpret_cast<const float2*>(a.off + pg * 18 + 2 * k);
  const float m = a.mask[pg * 9 + k];
  const float py = __fadd_rn(static_cast<float>(yy - 1 + ky), d.x);
  const float px = __fadd_rn(static_cast<float>(xx - 1 + kx), d.y);
  const bool inside =
      py > -1.f && px > -1.f && py < static_cast<float>(a.h) && px < static_cast<float>(a.w);

  float w1 = 0.f, w2 = 0.f, w3 = 0.f, w4 = 0.f;
  bool ok1 = false, ok2 = false, ok3 = false, ok4 = false;
  const uint4* p1 = nullptr;
  long long stride_y = 0, stride_x = 0;  // in 16-byte vectors
  if (inside) {
    const float fy = floorf(py), fx = floorf(px);
    const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
    const float ly = __fsub_rn(py, fy), lx = __fsub_rn(px, fx);
    const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
    w1 = __fmul_rn(hy, hx);
    w2 = __fmul_rn(hy, lx);
    w3 = __fmul_rn(ly, hx);
    w4 = __fmul_rn(ly, lx);
    const bool top = y0 >= 0, bottom = y0 + 1 <= a.h - 1;
    const bool left = x0 >= 0, right = x0 + 1 <= a.w - 1;
    ok1 = top && left;
    ok2 = top && right;
    ok3 = bottom && left;
    ok4 = bottom && right;
    // corner (y0, x0) of the group's channels, in vectors; only the
    // corners inside the frame are read
    stride_x = a.c / kVec;
    stride_y = static_cast<long long>(a.w) * stride_x;
    p1 = reinterpret_cast<const uint4*>(a.x) + (frame * a.h + y0) * stride_y + x0 * stride_x +
         g * a.vecs;
  }
  uint4* dst = reinterpret_cast<uint4*>(a.cols) + (pg * 9 + k) * a.vecs;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int j = 0; j < a.vecs; ++j) {
    float v1[kVec], v2[kVec], v3[kVec], v4[kVec];
    unpack(ok1 ? __ldg(p1 + j) : zero, v1);
    unpack(ok2 ? __ldg(p1 + stride_x + j) : zero, v2);
    unpack(ok3 ? __ldg(p1 + stride_y + j) : zero, v3);
    unpack(ok4 ? __ldg(p1 + stride_y + stride_x + j) : zero, v4);
    uint4 raw;
    __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < kVec / 2; ++q) {
      float s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * q + e;
        float t = __fadd_rn(__fmul_rn(w1, v1[c]), __fmul_rn(w2, v2[c]));
        t = __fadd_rn(t, __fmul_rn(w3, v3[c]));
        t = __fadd_rn(t, __fmul_rn(w4, v4[c]));
        s[e] = __fmul_rn(t, m);
      }
      pair[q] = __floats2bfloat162_rn(s[0], s[1]);
    }
    dst[j] = raw;
  }
}

}  // namespace

extern "C" int elvis_dcn_columns(const void* x, const void* off, const void* mask, void* cols,
                                 int n, int h, int w, int c, int g, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (g < 1 || c % g != 0 || (c / g) % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(cols) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(off) % 8 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(off),
         static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(cols),
         static_cast<long long>(n) * h * w * g * 9, h, w, c, g, c / g / kVec};
  const long long blocks = (a.items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dcn_columns<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
