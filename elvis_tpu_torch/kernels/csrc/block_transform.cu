// Per-block two-sided matrix transform on Hopper (sm_90a), f32.
//
//   out[m, :, :, c] = T[idx[m]] . X[m, :, :, c] . T[idx[m]]^T
//
// Replaces the TPU kernel elvis_tpu/kernels/block_transform.py::
// apply_block_matrix_pallas_kron (pallas_call at line 280). That kernel
// reshapes each block to a b^2 vector and multiplies it by the
// column-stacked Kronecker operators of ALL L levels, (tile, b^2) @
// (b^2, L*b^2), to keep the TPU's matrix unit busy, then keeps each row's
// own level slice. It spends L x (b^2 / 2b) times the minimal FLOPs to
// buy matrix-unit occupancy.
//
// What bounds it on this card: bytes. At the main path's shape (b=8, L=4,
// C=3, 8 frames of 1080p) the op reads and writes 199 MB each, 0.12 ms at
// 3.35 TB/s, while the separable form is 1.6 GFLOP, 0.024 ms at the FP32
// rate. So the Kronecker tiling is not carried over: the kernel does the
// minimal separable arithmetic in FP32 FMAs (no TF32 — the reference runs
// at full f32 precision) and aims at one coalesced read and one coalesced
// write of the blocks.
//
// Design: each CTA stages the whole (L, b, b) table in shared memory
// (1 KB at b=8/L=4, 11 KB at b=8/L=11, 5 KB at b=16/L=5), then a group of
// `group` consecutive blocks (contiguous in memory in the (M, b, b, C)
// layout) and their levels. Pass 1 forms Y = T X in shared memory; pass 2
// forms Z = Y T^T and writes it straight to global memory in the input's
// element order. Threads walk the group's elements linearly, so both the
// load and the store are coalesced.
//
// Levels outside [0, L) are clamped, as JAX's gather clamps them.
// b is a template parameter (8 or 16); L <= 16 and C come at run time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int B>
__global__ void __launch_bounds__(kThreads)
block_transform_kernel(const float* __restrict__ x, const float* __restrict__ table,
                       const int* __restrict__ idx, float* __restrict__ out,
                       long long m, int c, int levels, int group) {
  extern __shared__ float smem[];
  const int per = B * B * c;   // floats per block
  const int row = B * c;       // floats per block row
  float* s_t = smem;                         // levels * B * B
  float* s_x = s_t + levels * B * B;         // group * per
  float* s_y = s_x + group * per;            // group * per
  int* s_l = reinterpret_cast<int*>(s_y + group * per);  // group

  const long long m0 = static_cast<long long>(blockIdx.x) * group;
  const int g_n = static_cast<int>(min(static_cast<long long>(group), m - m0));
  const int n = g_n * per;
  const float* xg = x + m0 * per;
  float* og = out + m0 * per;

  for (int e = threadIdx.x; e < levels * B * B; e += kThreads) s_t[e] = table[e];
  for (int g = threadIdx.x; g < g_n; g += kThreads) {
    const int l = idx[m0 + g];
    s_l[g] = min(max(l, 0), levels - 1);
  }
  for (int e = threadIdx.x; e < n; e += kThreads) s_x[e] = xg[e];
  __syncthreads();

  // Pass 1: y[g, i, k, ch] = sum_j T[i, j] x[g, j, k, ch]
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int g = e / per;
    const int r = e - g * per;
    const int i = r / row;
    const int kc = r - i * row;
    const float* t = s_t + s_l[g] * B * B + i * B;
    const float* xc = s_x + g * per + kc;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < B; ++j) acc = fmaf(t[j], xc[j * row], acc);
    s_y[e] = acc;
  }
  __syncthreads();

  // Pass 2: z[g, i, l, ch] = sum_k y[g, i, k, ch] T[l, k]
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int g = e / per;
    const int r = e - g * per;
    const int i = r / row;
    const int lc = r - i * row;
    const int l = lc / c;
    const int ch = lc - l * c;
    const float* t = s_t + s_l[g] * B * B + l * B;
    const float* yr = s_y + g * per + i * row + ch;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < B; ++k) acc = fmaf(yr[k * c], t[k], acc);
    og[e] = acc;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Shapes: x and out (m, b, b, c)
// f32, table (levels, b, b) f32, idx (m,) int32, all contiguous on the
// current device. Launches on `stream`, does not synchronise, and returns
// the launch's cudaGetLastError() as an int (0 = cudaSuccess).
extern "C" int elvis_block_transform(const float* x, const float* table, const int* idx,
                                     float* out, long long m, int b, int c, int levels,
                                     int group, void* stream) {
  if (m <= 0) return 0;
  if (levels < 1 || levels > 16 || c < 1 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = (m + group - 1) / group;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(levels) * b * b +
                       2 * static_cast<size_t>(group) * b * b * c) * sizeof(float) +
                      static_cast<size_t>(group) * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(ctas));
  if (b == 8) {
    block_transform_kernel<8><<<grid, kThreads, smem, s>>>(x, table, idx, out, m, c, levels, group);
  } else if (b == 16) {
    block_transform_kernel<16><<<grid, kThreads, smem, s>>>(x, table, idx, out, m, c, levels, group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
