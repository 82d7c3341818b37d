// The SR nets' float32 tail on Hopper (sm_90a): a 3x3 SAME convolution from
// Cin bf16 channels to 3 float32 channels, with its bias, read in place from
// the bf16 trunk output.
//
//   out[p, o] = bias[o] + sum_c sum_ky sum_kx w[o, c, ky, kx] * x[p + (ky-1, kx-1), c]
//
// over the full-resolution image, zero outside it, in float32 FFMA (the
// widening of bf16 to float32 is exact). Two input geometries, one image
// of hf x wf full-resolution pixels each:
//   * phase:  x (N, H, W, 2, 2, Cin) -> out (N, H, W, 2, 2, 3), hf = 2H,
//     wf = 2W; full-res pixel (2i + a, 2j + b) is x[n, i, j, a, b] (the
//     pixel shuffle the nets' `up` conv feeds), so each output pixel reads
//     its 9 real taps and none of the zeros of the phase-domain kernel;
//   * direct: x (N, H, W, Cin) -> out (N, H, W, 3), hf = H, wf = W.
// The geometry changes only where a pixel lies in memory: both compute the
// same sums in the same order, so the phase result, interleaved, equals the
// direct result on the interleaved input bit for bit.
//
// Replaces no TPU kernel: on the TPU, XLA runs this conv. On the card it was
// cuDNN's NCHW FFMA implicit GEMM over a float32 copy of the input in NCHW,
// and in the phase form over a 4 Cin -> 12 kernel that is three quarters
// zeros.
//
// What bounds it on this card: both, nearly evenly. An output pixel reads
// 2 Cin bytes and does 27 Cin FFMAs (54 Cin FLOPs), 27 FLOPs a byte against
// the card's 20 (67 TFLOP/s FFMA over 3.35 TB/s). RRDB's tail at 8 x 1080p
// (Cin 128, three stages of a segment): 5.6 GB of bf16 read (1.7 ms) and 0.15
// TFLOP (2.2 ms); Real-ESRGAN's conv_last (Cin 64, direct): 2.8 GB (0.8 ms)
// and 75 GFLOP (1.1 ms).
//
// The records kernel (Cin 16, 32, 64 or 128, 16-byte aligned: the RRDB tail,
// Real-ESRGAN's conv_last) reads the input once, whole:
//   * a persistent CTA of 8 warps walks over output tiles of 16 rows x 16
//     columns (Cin 128) or 16 x 32 (fewer channels). Each tile's input and
//     its one-pixel halo are copied into shared memory as they lie in
//     device memory, every pixel's Cin channels together, by the copy
//     engine: one bulk copy a halo row, the rows that lie together in
//     memory (full-res rows; in the phase form low-res rows of 2 x 2 phase
//     groups, the tiles starting at odd full-res coordinates so that a halo
//     is whole groups), completing on an mbarrier. Double-buffered: the
//     next tile's copies are in flight while the warps compute this one,
//     and they cost the warps no instructions;
//   * lanes split the channels, two a lane (channels 2l and 2l + 1, then
//     64 + 2l and 65 + 2l): a warp reads one pixel's channels as one
//     conflict-free 32-bit load a lane, and each lane's 54 weights of a
//     channel pair sit in registers (read once a block from a tap-major
//     copy in shared memory). A warp computes a block of 4 x 8 output
//     pixels: every input word it loads feeds up to 54 FFMAs into its 96
//     float32 accumulators (32 pixels x 3 outputs);
//   * the 32 lanes' partial sums of a block are added through shared memory
//     in a fixed order (lane l ends with pixel l's 3 outputs), the bias last.
// Other channel counts (the student's 3), or an input not 16-byte aligned,
// take the planar kernel: the tile's halo in chunks of 4 channels read one
// by one, widened to float32 and stored one plane a channel, each thread
// 2 x 4 output pixels.
//
// No atomics, and one summation order in each kernel: two calls are
// bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWStride = 28;   // 27 packed weights a channel, padded to 7 float4
constexpr int kCout = 3;
constexpr int kTileH = 16;     // full-res output rows of a tile, both kernels

struct Args {
  const __nv_bfloat16* x;
  const float* w;     // (ceil(cin / 4) * 4, 28), zero past cin
  const float* bias;  // (3,)
  float* out;
  int hf, wf, cin;    // full-res height and width, input channels
  int tiles_x, tiles_y, tiles;
};

// Index of full-res pixel (y, x) of image `img` among the tensor's pixels.
template <bool kPhase>
__device__ __forceinline__ long long pixel(const Args& a, int img, int y, int x) {
  const long long base = static_cast<long long>(img) * a.hf * a.wf;
  if constexpr (kPhase) {
    return base + (static_cast<long long>(y >> 1) * (a.wf >> 1) + (x >> 1)) * 4 +
           (y & 1) * 2 + (x & 1);
  }
  return base + static_cast<long long>(y) * a.wf + x;
}

// Image and full-res origin of tile `tile` (tiles_x across, tiles_y down,
// then images). With `odd`, tiles start one tile before the image, at odd
// coordinates, so that a tile's halo is whole 2 x 2 phase groups.
__device__ __forceinline__ void tile_origin(const Args& a, int tile, int tile_w, bool odd,
                                            int* img, int* y0, int* x0) {
  const int tx = tile % a.tiles_x;
  const int rest = tile / a.tiles_x;
  *img = rest / a.tiles_y;
  *y0 = (rest - *img * a.tiles_y) * kTileH - (odd ? kTileH - 1 : 0);
  *x0 = tx * tile_w - (odd ? tile_w - 1 : 0);
}

__device__ __forceinline__ void store_out(const Args& a, long long p, const float* v) {
  float* dst = a.out + p * kCout;
#pragma unroll
  for (int o = 0; o < kCout; ++o) dst[o] = v[o] + __ldg(a.bias + o);
}

// ---- the records kernel --------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// The one arrival of a phase, with the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete; traps (a launch error, not a
// hang) if it has not after some 2^24 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (int tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 24)) __trap();
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, by the
// copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kPhase, int kCin>
struct Records {
  static constexpr int kTileW = kCin > 64 ? 16 : 32;
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kHaloPx = (kTileH + 2) * kHaloW;
  // The halo as rows of units that lie together in memory: full-res rows of
  // pixels (direct), or low-res rows of 2 x 2 phase groups (phase; the tile
  // starts at odd coordinates, so its halo is whole groups).
  static constexpr int kUnitPx = kPhase ? 4 : 1;
  static constexpr int kUnitBytes = kUnitPx * kCin * 2;
  static constexpr int kHaloRows = kPhase ? kTileH / 2 + 1 : kTileH + 2;
  static constexpr int kHaloCols = kPhase ? kTileW / 2 + 1 : kTileW + 2;
  static constexpr int kGroups = (kCin + 63) / 64;  // channel pairs a lane
  static constexpr int kBlocksX = kTileW / 8;  // blocks of 4 x 8 output pixels
  static constexpr int kBlocks = (kTileH / 4) * kBlocksX;
  static constexpr int kRedStride = 36;  // a lane's row of partial sums, 16-byte aligned
  static constexpr size_t kBufBytes = static_cast<size_t>(kHaloPx) * kCin * 2;
  static constexpr size_t kSmemBytes = 2 * kBufBytes + 27 * kCin * sizeof(float) +
                                       kWarps * 32 * kRedStride * sizeof(float) +
                                       2 * sizeof(uint64_t);
  static_assert(kCin % 16 == 0 && (kCin & (kCin - 1)) == 0 && kCin <= 128, "Cin 16 .. 128");
  static_assert(kBlocks % kWarps == 0, "whole blocks a warp");
  static_assert(kHaloRows * kHaloCols * kUnitPx == kHaloPx && kHaloRows <= 32, "halo");

  // shared-memory pixel of full-res halo pixel (ry, rx), from the tile's
  // origin less one; for even ry0, rx0, px(ry0 + ry, rx0 + rx) = px(ry0,
  // rx0) + px(ry, rx)
  __host__ __device__ static constexpr int px(int ry, int rx) {
    return kPhase ? (((ry >> 1) * kHaloCols + (rx >> 1)) * 2 + (ry & 1)) * 2 + (rx & 1)
                  : ry * kHaloW + rx;
  }
};

// Start the copies of a tile's halo into `buf`: warp 0 sends one bulk copy
// a halo row (its part inside the image) to the copy engine, completing on
// `bar`; on a tile at the image's edge every thread zeroes the rest.
template <bool kPhase, int kCin>
__device__ __forceinline__ void issue_tile(const Args& a, int tile, unsigned char* buf,
                                           uint64_t* bar) {
  using R = Records<kPhase, kCin>;
  int img, y0, x0;
  tile_origin(a, tile, R::kTileW, kPhase, &img, &y0, &x0);
  const int rows = kPhase ? a.hf / 2 : a.hf, cols = kPhase ? a.wf / 2 : a.wf;
  const int r0 = kPhase ? (y0 - 1) / 2 : y0 - 1, c0 = kPhase ? (x0 - 1) / 2 : x0 - 1;
  const int lo = max(c0, 0), hi = min(c0 + R::kHaloCols, cols);  // the columns inside
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, r = r0 + lane;
    const bool copy = lane < R::kHaloRows && r >= 0 && r < rows && hi > lo;
    const unsigned bytes = copy ? static_cast<unsigned>(hi - lo) * R::kUnitBytes : 0u;
    const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) mbar_expect(bar, total);
    __syncwarp();
    if (copy) {
      const long long unit = (static_cast<long long>(img) * rows + r) * cols + lo;
      bulk_copy(buf + (static_cast<size_t>(lane) * R::kHaloCols + (lo - c0)) * R::kUnitBytes,
                a.x + unit * R::kUnitPx * kCin, bytes, bar);
    }
  }
  if (r0 < 0 || r0 + R::kHaloRows > rows || lo > c0 || hi < c0 + R::kHaloCols) {
    constexpr int kChunks = R::kUnitBytes / 16;
    for (int i = threadIdx.x; i < R::kHaloRows * R::kHaloCols * kChunks; i += kThreads) {
      const int unit = i / kChunks, row = r0 + unit / R::kHaloCols;
      const int col = c0 + unit % R::kHaloCols;
      if (row < 0 || row >= rows || col < lo || col >= hi) {
        reinterpret_cast<uint4*>(buf)[i] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// One warp's block of 4 x 8 output pixels at (by, bx) of the tile in `buf`:
// each lane's partial sums over its channels into acc.
template <bool kPhase, int kCin>
__device__ __forceinline__ void block_partials(const unsigned char* buf, const float* s_w,
                                               int by, int bx, int lane,
                                               float (&acc)[4][8][kCout]) {
  using R = Records<kPhase, kCin>;
#pragma unroll 1
  for (int g = 0; g < R::kGroups; ++g) {
    const int c = g * 64 + 2 * lane;  // the lane's channel pair
    const bool active = kCin % 64 == 0 || c < kCin;
    float w0[27], w1[27];
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const float2 p = active ? *reinterpret_cast<const float2*>(s_w + t * kCin + c)
                              : make_float2(0.f, 0.f);
      w0[t] = p.x;
      w1[t] = p.y;
    }
    const unsigned char* base = buf + (static_cast<size_t>(R::px(by, bx)) * kCin + c) * 2;
#pragma unroll
    for (int wr = 0; wr < 6; ++wr) {
#pragma unroll
      for (int wc = 0; wc < 10; ++wc) {
        const uint32_t word =
            active ? *reinterpret_cast<const uint32_t*>(base + R::px(wr, wc) * kCin * 2) : 0u;
        const float f0 = __uint_as_float(word << 16);  // channel c (the low half)
        const float f1 = __uint_as_float(word & 0xffff0000u);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int oy = wr - ky;
          if (oy < 0 || oy > 3) continue;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int ox = wc - kx;
            if (ox < 0 || ox > 7) continue;
#pragma unroll
            for (int o = 0; o < kCout; ++o) {
              const int t = (ky * 3 + kx) * kCout + o;
              acc[oy][ox][o] = fmaf(f0, w0[t], acc[oy][ox][o]);
              acc[oy][ox][o] = fmaf(f1, w1[t], acc[oy][ox][o]);
            }
          }
        }
      }
    }
  }
}

template <bool kPhase, int kCin>
__global__ void __launch_bounds__(kThreads, 1) tail_conv_records(Args a) {
  using R = Records<kPhase, kCin>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_w = reinterpret_cast<float*>(smem + 2 * R::kBufBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* red = s_w + 27 * kCin + warp * 32 * R::kRedStride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_w + 27 * kCin + kWarps * 32 * R::kRedStride);

  int tile = blockIdx.x;
  if (tile >= a.tiles) return;
  // the weights tap-major, s_w[t * Cin + c], so that a warp reads a tap's
  // 64 channels as one conflict-free float2 a lane
  for (int i = threadIdx.x; i < kCin * 27; i += kThreads) {
    s_w[(i % 27) * kCin + i / 27] = __ldg(a.w + (i / 27) * kWStride + i % 27);
  }
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  issue_tile<kPhase, kCin>(a, tile, smem, bars);
  __syncthreads();  // the first tile's zeroed edge
  for (int k = 0; tile < a.tiles; ++k, tile += gridDim.x) {
    const int b = k & 1;
    if (tile + gridDim.x < a.tiles) {
      issue_tile<kPhase, kCin>(a, tile + gridDim.x, smem + (1 - b) * R::kBufBytes, bars + 1 - b);
    }
    mbar_wait(bars + b, (k >> 1) & 1);  // this tile's copies, sent during the tile before
    const unsigned char* buf = smem + b * R::kBufBytes;
    int img, y0, x0;
    tile_origin(a, tile, R::kTileW, kPhase, &img, &y0, &x0);
#pragma unroll 1
    for (int blk = warp; blk < R::kBlocks; blk += kWarps) {
      const int by = (blk / R::kBlocksX) * 4, bx = (blk % R::kBlocksX) * 8;
      if (y0 + by >= a.hf || y0 + by + 3 < 0 || x0 + bx >= a.wf || x0 + bx + 7 < 0) continue;
      float acc[4][8][kCout];
#pragma unroll
      for (int oy = 0; oy < 4; ++oy)
#pragma unroll
        for (int ox = 0; ox < 8; ++ox)
#pragma unroll
          for (int o = 0; o < kCout; ++o) acc[oy][ox][o] = 0.f;
      block_partials<kPhase, kCin>(buf, s_w, by, bx, lane, acc);
      // lane l: the sum over the 32 lanes of pixel l's partials, in a fixed
      // order (lanes r = 0, 4, ...; 1, 5, ...; then the four sums pairwise)
      float v[kCout];
#pragma unroll
      for (int o = 0; o < kCout; ++o) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int p = 4 * q;
          *reinterpret_cast<float4*>(red + lane * R::kRedStride + p) =
              make_float4(acc[p / 8][p % 8][o], acc[(p + 1) / 8][(p + 1) % 8][o],
                          acc[(p + 2) / 8][(p + 2) % 8][o], acc[(p + 3) / 8][(p + 3) % 8][o]);
        }
        __syncwarp();
        float s[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, so that the adds overlap
#pragma unroll
        for (int r = 0; r < 32; ++r) s[r % 4] += red[r * R::kRedStride + lane];
        v[o] = (s[0] + s[1]) + (s[2] + s[3]);
        __syncwarp();
      }
      const int y = y0 + by + lane / 8, x = x0 + bx + lane % 8;
      if (y >= 0 && y < a.hf && x >= 0 && x < a.wf) store_out(a, pixel<kPhase>(a, img, y, x), v);
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
}

// ---- the planar kernel ---------------------------------------------------

constexpr int kPlanarW = 128;      // full-res output columns of a tile, 4 a lane
constexpr int kPlanarHaloH = kTileH + 2;
constexpr int kPlanarHaloW = kPlanarW + 2;
constexpr int kRow = kPlanarW + 8;  // image column x lies at x - x0 + 4 of a row
constexpr int kPlane = kPlanarHaloH * kRow;

constexpr int kChunk = 4;  // channels a chunk, read one by one
constexpr size_t kPlanarSmemBytes = static_cast<size_t>(kChunk) * (kPlane + kWStride) * 4;

// Channels c0 .. c0 + kChunk - 1 of the tile's halo into the planes, as
// float32 (zero outside the image and past cin), and their packed weights.
template <bool kPhase>
__device__ __forceinline__ void stage(const Args& a, int img, int y0, int x0, int c0,
                                      float* s_in, float* s_w) {
  for (int i = threadIdx.x; i < kPlanarHaloH * kPlanarHaloW; i += kThreads) {
    const int ry = i / kPlanarHaloW, rx = i - ry * kPlanarHaloW;
    const int y = y0 - 1 + ry, x = x0 - 1 + rx;
    float v[kChunk] = {0.f, 0.f, 0.f, 0.f};
    if (y >= 0 && y < a.hf && x >= 0 && x < a.wf) {
      const __nv_bfloat16* src = a.x + pixel<kPhase>(a, img, y, x) * a.cin + c0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (c0 + k < a.cin) v[k] = __bfloat162float(src[k]);
      }
    }
    float* dst = s_in + ry * kRow + rx + 3;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) dst[k * kPlane] = v[k];
  }
  for (int i = threadIdx.x; i < kChunk * kWStride; i += kThreads) {
    s_w[i] = __ldg(a.w + static_cast<long long>(c0) * kWStride + i);
  }
}

// acc[py][px][o] += the chunk's taps for the thread's 2 x 4 output pixels:
// a warp reads a row of a plane as one 16-byte load a lane and takes the two
// neighbouring columns from its neighbour lanes (the tile's edge lanes from
// one broadcast); a channel's 27 weights come as 7 broadcast float4.
__device__ __forceinline__ void accumulate(const float* s_in, const float* s_w, int warp,
                                           int lane, float (&acc)[2][4][kCout]) {
#pragma unroll 1
  for (int c = 0; c < kChunk; ++c) {
    float w[kWStride];
    const float4* w4 = reinterpret_cast<const float4*>(s_w + c * kWStride);
#pragma unroll
    for (int q = 0; q < kWStride / 4; ++q) {
      const float4 t = w4[q];
      w[4 * q] = t.x;
      w[4 * q + 1] = t.y;
      w[4 * q + 2] = t.z;
      w[4 * q + 3] = t.w;
    }
    const float* plane = s_in + c * kPlane + 2 * warp * kRow;
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // input rows: output row py takes rows py .. py + 2
      const float* row = plane + r * kRow;
      const float4 m = *reinterpret_cast<const float4*>(row + 4 + 4 * lane);
      const float edge = row[lane == 0 ? 3 : kPlanarW + 4];  // the halo columns
      float left = __shfl_up_sync(0xffffffffu, m.w, 1);
      float right = __shfl_down_sync(0xffffffffu, m.x, 1);
      if (lane == 0) left = edge;
      if (lane == 31) right = edge;
      const float v[6] = {left, m.x, m.y, m.z, m.w, right};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int py = r - ky;
        if (py < 0 || py > 1) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int px = 0; px < 4; ++px) {
#pragma unroll
            for (int o = 0; o < kCout; ++o) {
              acc[py][px][o] = fmaf(v[px + kx], w[(ky * 3 + kx) * kCout + o], acc[py][px][o]);
            }
          }
        }
      }
    }
  }
}

template <bool kPhase>
__global__ void __launch_bounds__(kThreads, 2) tail_conv_planar(Args a) {
  extern __shared__ __align__(16) float smem_f[];
  float* s_in = smem_f;
  float* s_w = smem_f + kChunk * kPlane;
  int img, y0, x0;
  tile_origin(a, blockIdx.x, kPlanarW, false, &img, &y0, &x0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float total[2][4][kCout];
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int px = 0; px < 4; ++px)
#pragma unroll
      for (int o = 0; o < kCout; ++o) total[py][px][o] = 0.f;

  for (int c0 = 0; c0 < a.cin; c0 += kChunk) {
    __syncthreads();  // every warp is done with the previous chunk
    stage<kPhase>(a, img, y0, x0, c0, s_in, s_w);
    __syncthreads();
    float acc[2][4][kCout];
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 4; ++px)
#pragma unroll
        for (int o = 0; o < kCout; ++o) acc[py][px][o] = 0.f;
    accumulate(s_in, s_w, warp, lane, acc);
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 4; ++px)
#pragma unroll
        for (int o = 0; o < kCout; ++o) total[py][px][o] += acc[py][px][o];
  }

#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const int y = y0 + 2 * warp + py;
    if (y >= a.hf) continue;
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      const int x = x0 + 4 * lane + px;
      if (x < a.wf) store_out(a, pixel<kPhase>(a, img, y, x), total[py][px]);
    }
  }
}

// ---- launch ----------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int grid, const Args& a, cudaStream_t stream) {
  // per call, so that every device the process uses gets the attributes
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPhase, int kCin>
int launch_records(Args a, int n, int sms, cudaStream_t stream) {
  using R = Records<kPhase, kCin>;
  const int shift = kPhase ? 1 : 0;  // the phase tiles start one tile early
  a.tiles_x = (a.wf + R::kTileW - 1) / R::kTileW + shift;
  a.tiles_y = (a.hf + kTileH - 1) / kTileH + shift;
  const long long tiles = static_cast<long long>(n) * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  const int grid = a.tiles < sms ? a.tiles : sms;
  return launch(tail_conv_records<kPhase, kCin>, R::kSmemBytes, grid, a, stream);
}

template <bool kPhase>
int launch_planar(Args a, int n, cudaStream_t stream) {
  a.tiles_x = (a.wf + kPlanarW - 1) / kPlanarW;
  a.tiles_y = (a.hf + kTileH - 1) / kTileH;
  const long long tiles = static_cast<long long>(n) * a.tiles_x * a.tiles_y;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  return launch(tail_conv_planar<kPhase>, kPlanarSmemBytes, a.tiles, a, stream);
}

template <bool kPhase>
int dispatch(const Args& a, int n, bool aligned, int sms, cudaStream_t s) {
  if (aligned) {
    switch (a.cin) {
      case 16: return launch_records<kPhase, 16>(a, n, sms, s);
      case 32: return launch_records<kPhase, 32>(a, n, sms, s);
      case 64: return launch_records<kPhase, 64>(a, n, sms, s);
      case 128: return launch_records<kPhase, 128>(a, n, sms, s);
      default: break;
    }
  }
  return launch_planar<kPhase>(a, n, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). x: n images of hf x wf full-res
// pixels of cin bf16 channels, in the phase layout (phase != 0; hf and wf
// even) or the direct one, contiguous; w: the packed weights, (ceil(cin / 4)
// * 4, 28) float32 with w[c, (ky * 3 + kx) * 3 + o] = weight[o, c, ky, kx]
// and zeros past cin; bias (3,) float32; out: n x hf x wf x 3 float32 in the
// input's geometry; `sms` the device's SM count. Launches on `stream` on the
// current device, does not synchronise, and returns the launch's
// cudaGetLastError() as an int (0 = cudaSuccess; cudaErrorInvalidValue for a
// size out of range).
extern "C" int elvis_tail_conv(const void* x, const void* w, const void* bias, void* out, int n,
                               int hf, int wf, int cin, int phase, int sms, void* stream) {
  if (n < 0 || hf < 0 || wf < 0 || cin < 1 || sms < 1 || (phase && ((hf | wf) & 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || hf == 0 || wf == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
               static_cast<const float*>(bias), static_cast<float*>(out), hf, wf, cin,
               0, 0, 0};
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return phase ? dispatch<true>(a, n, aligned, sms, s) : dispatch<false>(a, n, aligned, sms, s);
}
