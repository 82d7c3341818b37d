// Epilogue of the SR nets' bf16 trunk convolutions on Hopper (sm_90a): the
// bias, the leaky ReLU and up to two scaled residuals of one conv output,
// in place, in one pass.
//
//   t = bf16(y + b[c])
//   t = t > 0 ? t : bf16(t * slope)        with a slope
//   t = bf16(r1 + bf16(s1 * t))            with a residual r1
//   t = bf16(r2 + bf16(s2 * t))            with an outer residual r2
//
// y, r1 and r2 are (N, H, W, C) bf16, contiguous (channels last), b is (C,)
// bf16; the scalars are float32. Every step rounds to bf16 where PyTorch's
// eager route does (its elementwise kernels compute in float32 and store
// bf16), so the result is bit-equal to
//   conv2d(x, w, b) -> leaky_relu -> r1 + s1 * (.) -> r2 + s2 * (.)
// on the card: there cuDNN runs the conv without the bias and PyTorch adds
// it after in a pass of its own, bf16(y + b). With s1 = 1 the residual step
// is bf16(r1 + t), as t is a bf16 value already.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the flax model's bias,
// activation and residual sums into the convolution. On the card each of
// them was a pass of its own over the conv output (the bias add a broadcast
// over a channels-last tensor that PyTorch's elementwise kernel does not
// vectorise).
//
// What bounds it on this card: bytes. An element is 2 B read and 2 B
// written of y, and 2 B read of each residual, against a handful of float32
// operations. So the design is a streaming pass:
//   * each thread moves 8 channels (16 bytes) per access of y, r1 and r2;
//   * the C biases go to shared memory once per CTA, as float32; a vector
//     reads its 8 as two float4 when C is a multiple of 8 (kWide), else
//     one by one with the channel index wrapping at C (C = 12, say). C is
//     at most kMaxChannels, which covers the up conv (4 x features) of an
//     RRDB net up to 512 features; the shipped nets reach 512;
//   * a grid-stride loop over a grid of one wave (the SM count times the
//     CTAs that fit an SM, asked of the runtime once per instantiation), so
//     the bias staging is paid once per CTA; the channel of a thread's
//     vector advances by a fixed step each trip;
//   * the N*H*W*C % 8 trailing elements go one per thread of the first CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 elements in a 16-byte access
constexpr int kMaxChannels = 2048;  // the biases, as float32, take 8 KB of shared memory

struct Args {
  __nv_bfloat16* y;
  const __nv_bfloat16* bias;
  const __nv_bfloat16* r1;
  const __nv_bfloat16* r2;
  long long n;  // elements of y
  int c;
  float slope, s1, s2;
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kSlope, bool kR1, bool kR2>
__device__ __forceinline__ float epilogue(float y, float b, float r1, float r2,
                                          const Args& a) {
  float t = to_bf16(y + b);
  if (kSlope) t = t > 0.f ? t : to_bf16(t * a.slope);
  if (kR1) t = to_bf16(r1 + to_bf16(a.s1 * t));
  if (kR2) t = to_bf16(r2 + to_bf16(a.s2 * t));
  return t;
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

template <bool kWide, bool kSlope, bool kR1, bool kR2>
__global__ void __launch_bounds__(kThreads) conv_epilogue_kernel(Args a) {
  __shared__ __align__(16) float s_bias[kMaxChannels];
  for (int i = threadIdx.x; i < a.c; i += kThreads) s_bias[i] = __bfloat162float(a.bias[i]);
  __syncthreads();

  const long long vecs = a.n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int step = static_cast<int>((stride * kVec) % a.c);
  int c0 = static_cast<int>((first * kVec) % a.c);  // channel of the vector's first element
  uint4* y = reinterpret_cast<uint4*>(a.y);
  const uint4* r1 = reinterpret_cast<const uint4*>(a.r1);
  const uint4* r2 = reinterpret_cast<const uint4*>(a.r2);
  for (long long v = first; v < vecs; v += stride) {
    float fy[kVec], fb[kVec], f1[kVec] = {}, f2[kVec] = {};
    unpack(y[v], fy);
    if (kR1) unpack(__ldg(r1 + v), f1);
    if (kR2) unpack(__ldg(r2 + v), f2);
    if (kWide) {  // c0 is a multiple of 8 and c0 + 7 < C
      const float4 b0 = *reinterpret_cast<const float4*>(s_bias + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(s_bias + c0 + 4);
      fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
      fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
    } else {
      int ch = c0;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        fb[i] = s_bias[ch];
        ch = ch + 1 == a.c ? 0 : ch + 1;
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) fy[i] = epilogue<kSlope, kR1, kR2>(fy[i], fb[i], f1[i], f2[i], a);
    y[v] = pack(fy);
    c0 += step;
    if (c0 >= a.c) c0 -= a.c;
  }

  const long long e = vecs * kVec + first;  // the ragged tail, under 8 elements
  if (e < a.n) {
    const float f1 = kR1 ? __bfloat162float(a.r1[e]) : 0.f;
    const float f2 = kR2 ? __bfloat162float(a.r2[e]) : 0.f;
    const float t = epilogue<kSlope, kR1, kR2>(__bfloat162float(a.y[e]),
                                               s_bias[static_cast<int>(e % a.c)], f1, f2, a);
    a.y[e] = __float2bfloat16_rn(t);
  }
}

// CTAs of one instantiation that fit an SM, asked of the runtime at its
// first launch (a C++ static: initialised once, thread-safe); a negative
// value is the failed query's error code.
template <bool kWide, bool kSlope, bool kR1, bool kR2>
int ctas_per_sm() {
  static const int per_sm = [] {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, conv_epilogue_kernel<kWide, kSlope, kR1, kR2>, kThreads, 0);
    return err != cudaSuccess ? -static_cast<int>(err) : (n > 0 ? n : 1);
  }();
  return per_sm;
}

template <bool kWide, bool kSlope, bool kR1, bool kR2>
int launch(const Args& a, int sms, cudaStream_t stream) {
  const int per_sm = ctas_per_sm<kWide, kSlope, kR1, kR2>();
  if (per_sm < 0) return -per_sm;
  const long long vecs = a.n / kVec;
  const long long need = (vecs + kThreads - 1) / kThreads;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;  // the tail alone
  conv_epilogue_kernel<kWide, kSlope, kR1, kR2>
      <<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWide>
int dispatch(const Args& a, bool slope, int sms, cudaStream_t s) {
  const bool r1 = a.r1 != nullptr, r2 = a.r2 != nullptr;
  if (r2 && !r1) return static_cast<int>(cudaErrorInvalidValue);
  if (slope) {
    if (r2) return launch<kWide, true, true, true>(a, sms, s);
    if (r1) return launch<kWide, true, true, false>(a, sms, s);
    return launch<kWide, true, false, false>(a, sms, s);
  }
  if (r2) return launch<kWide, false, true, true>(a, sms, s);
  if (r1) return launch<kWide, false, true, false>(a, sms, s);
  return launch<kWide, false, false, false>(a, sms, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). y (n elements, the last axis of
// c channels, 1 <= c <= kMaxChannels) is updated in place; r1 and r2 may
// be null (r2 only with r1), and then their scale is not read; has_slope 0
// skips the leaky ReLU. y, r1 and r2 must be 16-byte aligned, on the
// current device; `sms` is its SM count. Launches on `stream`, does not
// synchronise, and returns the launch's cudaGetLastError() as an int
// (0 = cudaSuccess; cudaErrorInvalidValue for a c out of range).
extern "C" int elvis_conv_epilogue(void* y, const void* bias, const void* r1, const void* r2,
                                   long long n, int c, int has_slope, float slope, float s1,
                                   float s2, int sms, void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || c > kMaxChannels || n % c != 0 || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(r1) |
                         reinterpret_cast<uintptr_t>(r2)) % 16;
  if (mis != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{static_cast<__nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(bias),
         static_cast<const __nv_bfloat16*>(r1), static_cast<const __nv_bfloat16*>(r2),
         n, c, slope, s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c % kVec == 0 ? dispatch<true>(a, has_slope != 0, sms, s)
                       : dispatch<false>(a, has_slope != 0, sms, s);
}
