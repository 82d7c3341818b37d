// Per-block two-sided matrix transform on Hopper (sm_90a), on frames as
// they lie in memory or on an array of blocks.
//
//   out[block, :, :, ch] = T[level[block]] . X[block, :, :, ch] . T[level[block]]^T
//
// Replaces the TPU kernel elvis_tpu/kernels/block_transform.py::
// apply_block_matrix_pallas_kron (pallas_call at line 280). That kernel
// reshapes each block to a b^2 vector and multiplies it by the
// column-stacked Kronecker operators of ALL L levels to keep the TPU's
// matrix unit busy, then keeps each row's own level slice; the frames are
// cast to f32, cut into blocks, put together again, rounded and clipped by
// separate passes around it. None of that is carried over.
//
// What bounds it on this card: bytes. An 8-frame 1080p uint8 clip is
// 49.8 MB each way (0.030 ms at 3.35 TB/s) against 1.6 GFLOP of separable
// FP32 arithmetic (0.024 ms); as f32 blocks it is 199 MB each way
// (0.119 ms). So the kernel moves each element once, in the type the
// caller holds it in, and everything else happens on the SM:
//
//   * Strided addressing. A tile is a run of `group` neighbouring blocks.
//     In frame layout ((N, H, W, C) contiguous, levels (N, By, Bx)) it is b
//     image rows of group*b*C contiguous elements, so the split into blocks
//     and the combine are address arithmetic. In block layout ((M, b, b, C)
//     contiguous) it is group*b rows of b*C elements. Both are "rows of
//     `rowlen` elements, `grs` apart" to the copy loops.
//   * Types. Input uint8 or f32, output uint8 or f32 (template parameters).
//     uint8 is converted on the way into registers; a uint8 output is
//     rintf then clipped to [0, 255]. The tile is staged in the INPUT'S
//     type: an asynchronous copy cannot convert, and a uint8 tile is a
//     quarter of the size, so a CTA holds four times the blocks.
//   * 16-byte asynchronous copies (cp.async.cg) into a ring of two input
//     tiles: the next tile loads while this one is transformed. The result
//     goes to an output tile and from there to global memory in 16-byte
//     stores. cp.async was kept over a 2-D TMA box: a tile row is one
//     contiguous run, every thread has copy slots to spare (the arithmetic
//     is fed from registers), and the short last tile of a block row is
//     just a shorter run, with no tensor map to encode per clip. A scalar
//     path (run-time switch `vec`) serves bases, widths or groups that are
//     not 16-byte aligned.
//   * Persistent CTAs: as many as fit on the card walk over the tiles, so
//     the table is staged once per CTA and one tile's store overlaps the
//     next one's load.
//   * The arithmetic is block_transform_core.cuh: a sub-warp of b lanes per
//     block, operands in registers, Y through a padded scratch. C is a
//     template parameter for 1, 3 and 4: no run-time division in the loops,
//     and a sub-warp transforms all C channels of its block on one read of
//     T. Other C take the CT = 0 instantiation, one matrix at a time.
//   * Shared-memory rows have a pitch of an odd number of 16-byte units:
//     the row write of Z (lane stride = pitch) then spreads over the banks.
//   * Optional affine epilogue (template flag): per-level amount a,
//     out = clip((1 + a) X - a T X T^T, 0, 255), X itself where a <= 0 —
//     the unsharp mask. X is still in the input tile.
//
// FP32 FMAs only (no TF32: the reference runs at full f32 precision). A
// negative level wraps once (l + L) and what is still outside [0, L) is
// clamped, as indexing the table on the host does in the reference.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_transform_core.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB: what one CTA may opt in to

struct Params {
  const void* x;
  void* out;
  const float* table;   // (levels, B, B)
  const int* idx;       // one level per block, block rows contiguous
  const float* amount;  // (levels,) or null
  long long bx;         // blocks per block row (block layout: M)
  long long rb_stride;  // elements between block rows (block layout: 0)
  long long ntiles;
  long long tiles_per_row;
  int grs;              // elements between the rows of a tile in global memory
  int bstride;          // elements between neighbouring blocks of a run
  int frame;            // 1 = frame layout, 0 = block layout
  int c;
  int levels;
  int group;            // blocks per tile
  int pitch_in;         // bytes between the rows of a staged input tile
  int pitch_out;        // bytes between the rows of the output tile
  int vec;              // 1 = every row of every tile is 16-byte aligned
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(row, col) for every 16-byte chunk of `rows` rows of `cpr` chunks, one
// chunk a thread and trip, neighbouring threads on neighbouring chunks; the
// (row, col) pair is stepped, not divided out, on every trip.
template <int kThreads, typename F>
__device__ __forceinline__ void for_each_chunk(int rows, int cpr, int tid, F f) {
  const int total = rows * cpr;
  const int dq = kThreads / cpr, dr = kThreads - dq * cpr;
  int row = tid / cpr, col = tid - row * cpr;
  for (int e = tid; e < total; e += kThreads) {
    f(row, col);
    row += dq;
    col += dr;
    if (col >= cpr) { col -= cpr; ++row; }
  }
}

struct Tile {
  long long gbase;  // element offset of the tile's first element
  long long ibase;  // index of its first block's level
  int g_n;          // blocks in it (the last tile of a block row may be short)
};

__device__ __forceinline__ Tile tile_of(const Params& p, long long tile) {
  const long long r = tile / p.tiles_per_row;
  const long long bx0 = (tile - r * p.tiles_per_row) * p.group;
  Tile t;
  t.g_n = static_cast<int>(min(static_cast<long long>(p.group), p.bx - bx0));
  t.gbase = r * p.rb_stride + bx0 * p.bstride;
  t.ibase = r * p.bx + bx0;
  return t;
}

template <int B, int CT, typename TIn, typename TOut, bool AMOUNT>
__global__ void __launch_bounds__(elvis::CoreShape<B>::kThreads, 3)
block_transform_kernel(const Params p) {
  using Shape = elvis::CoreShape<B>;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kSub = Shape::kSub;  // sub-warps: blocks (CT > 0) or matrices in flight
  constexpr int kCB = CT > 0 ? CT : 1;  // channels a sub-warp transforms together
  const int c = CT > 0 ? CT : p.c;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_t = reinterpret_cast<float*>(smem);         // levels * kEntry
  float* s_amt = s_t + p.levels * Shape::kEntry;       // kMaxLevels
  float* s_scr = s_amt + kMaxLevels;                   // kSub * kCB * kScratch
  int* s_lvl = reinterpret_cast<int*>(s_scr + kSub * kCB * Shape::kScratch);  // 2 * gpad
  const int gpad = (p.group + 3) & ~3;
  unsigned char* s_in = reinterpret_cast<unsigned char*>(s_lvl + 2 * gpad);  // 2 tiles
  const int tile_rows = p.frame ? B : p.group * B;
  const int in_bytes = tile_rows * p.pitch_in;
  unsigned char* s_out = s_in + 2 * in_bytes;          // 1 tile

  const int in_rs = p.pitch_in / static_cast<int>(sizeof(TIn));     // elements
  const int out_rs = p.pitch_out / static_cast<int>(sizeof(TOut));
  const int gs_in = p.frame ? B * c : B * in_rs;       // block to block inside a tile
  const int gs_out = p.frame ? B * c : B * out_rs;

  // tile -> shared memory (asynchronous when p.vec), with its levels
  auto load_tile = [&](const Tile& t, int stage) {
    const int rows = p.frame ? B : t.g_n * B;
    const int rowlen = p.frame ? t.g_n * B * c : B * c;
    const TIn* src = static_cast<const TIn*>(p.x) + t.gbase;
    unsigned char* dst = s_in + stage * in_bytes;
    int* lvl = s_lvl + stage * gpad;
    if (p.vec) {
      const unsigned char* src_b = reinterpret_cast<const unsigned char*>(src);
      const long long grs_b = static_cast<long long>(p.grs) * sizeof(TIn);
      for_each_chunk<kThreads>(rows, rowlen * static_cast<int>(sizeof(TIn)) / 16, tid,
                               [&](int row, int col) {
        cp_async16(dst + row * p.pitch_in + col * 16, src_b + row * grs_b + col * 16);
      });
      for (int g = tid; g < t.g_n; g += kThreads) cp_async4(lvl + g, p.idx + t.ibase + g);
    } else {
      const int total = rows * rowlen;
      for (int e = tid; e < total; e += kThreads) {
        const int row = e / rowlen, col = e - row * rowlen;
        reinterpret_cast<TIn*>(dst)[row * in_rs + col] =
            src[static_cast<long long>(row) * p.grs + col];
      }
      for (int g = tid; g < t.g_n; g += kThreads) lvl[g] = p.idx[t.ibase + g];
    }
  };

  elvis::stage_table<B>(s_t, p.table, p.levels, tid, kThreads);
  if (AMOUNT) {
    for (int e = tid; e < p.levels; e += kThreads) s_amt[e] = p.amount[e];
  }

  const int lane = tid % B;
  float* scr = s_scr + (tid / B) * kCB * Shape::kScratch;
  const unsigned mask = elvis::sub_warp_mask<B>(tid);

  long long tile = blockIdx.x;
  if (p.vec) {
    if (tile < p.ntiles) load_tile(tile_of(p, tile), 0);
    cp_async_commit();
  }
  for (int it = 0; tile < p.ntiles; tile += gridDim.x, ++it) {
    const Tile cur = tile_of(p, tile);
    const int stage = p.vec ? (it & 1) : 0;
    if (p.vec) {
      // every thread commits one group per trip, empty or not, so that
      // "all but the newest" is this tile on every thread
      const long long next = tile + gridDim.x;
      if (next < p.ntiles) load_tile(tile_of(p, next), stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile(cur, 0);
    }
    __syncthreads();

    const TIn* tin = reinterpret_cast<const TIn*>(s_in + stage * in_bytes);
    TOut* tout = reinterpret_cast<TOut*>(s_out);
    const int* lvl = s_lvl + stage * gpad;
    // a sub-warp's unit of work: all channels of a block (CT > 0), or one
    // matrix of one block and channel
    const int units = cur.g_n * (c / kCB);
    for (int unit = tid / B; unit < units; unit += kSub) {
      const int g = CT > 0 ? unit : unit / c;
      const int ch = CT > 0 ? 0 : unit - g * c;
      const int l = elvis::wrap_level(lvl[g], p.levels);
      elvis::transform_matrix<B, kCB, TIn, TOut, AMOUNT>(
          tin + g * gs_in + ch, in_rs, tout + g * gs_out + ch, out_rs, c,
          s_t + l * Shape::kEntry, scr, lane, mask, AMOUNT ? s_amt[l] : 0.f);
    }
    __syncthreads();

    // output tile -> global memory
    const int rows = p.frame ? B : cur.g_n * B;
    const int rowlen = p.frame ? cur.g_n * B * c : B * c;
    TOut* dst = static_cast<TOut*>(p.out) + cur.gbase;
    if (p.vec) {
      unsigned char* dst_b = reinterpret_cast<unsigned char*>(dst);
      const long long grs_b = static_cast<long long>(p.grs) * sizeof(TOut);
      for_each_chunk<kThreads>(rows, rowlen * static_cast<int>(sizeof(TOut)) / 16, tid,
                               [&](int row, int col) {
        *reinterpret_cast<uint4*>(dst_b + row * grs_b + col * 16) =
            *reinterpret_cast<const uint4*>(s_out + row * p.pitch_out + col * 16);
      });
    } else {
      const int total = rows * rowlen;
      for (int e = tid; e < total; e += kThreads) {
        const int row = e / rowlen, col = e - row * rowlen;
        dst[static_cast<long long>(row) * p.grs + col] = tout[row * out_rs + col];
      }
    }
    // the next trip's first barrier comes before anything writes s_out or
    // the input tile this trip read
  }
  if (p.vec) cp_async_wait<0>();
}

// Bytes between the rows of a staged tile: the row rounded up to 16-byte
// units, made odd in those units (see the note at the top).
inline int pitch_bytes(long long row_bytes) {
  return static_cast<int>(((row_bytes + 15) / 16) | 1) * 16;
}

template <int B, int CT, typename TIn, typename TOut, bool AMOUNT>
int launch(Params p, long long rows, int max_ctas, cudaStream_t stream) {
  using Shape = elvis::CoreShape<B>;
  const int c = p.c;
  const long long rowlen = p.frame ? static_cast<long long>(p.group) * B * c : B * c;
  const long long tile_rows = p.frame ? B : static_cast<long long>(p.group) * B;
  p.pitch_in = pitch_bytes(rowlen * static_cast<long long>(sizeof(TIn)));
  p.pitch_out = pitch_bytes(rowlen * static_cast<long long>(sizeof(TOut)));
  const int gpad = (p.group + 3) & ~3;
  const size_t smem = (static_cast<size_t>(p.levels) * Shape::kEntry + kMaxLevels +
                       static_cast<size_t>(Shape::kSub) * (CT > 0 ? CT : 1) * Shape::kScratch +
                       2 * gpad) * 4 +
                      static_cast<size_t>(tile_rows) * (2 * p.pitch_in + p.pitch_out);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  // 16-byte path: both bases, every row start and every row length
  const long long last = p.bx % p.group;  // blocks in a block row's short last tile
  const auto aligned = [&](long long sz, const void* base) {
    const long long last_b = p.frame ? last * B * c * sz : 0;
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 && (rowlen * sz) % 16 == 0 &&
           last_b % 16 == 0 && (p.grs * sz) % 16 == 0 && (p.rb_stride * sz) % 16 == 0;
  };
  p.vec = (aligned(sizeof(TIn), p.x) && aligned(sizeof(TOut), p.out)) ? 1 : 0;

  p.tiles_per_row = (p.bx + p.group - 1) / p.group;
  p.ntiles = rows * p.tiles_per_row;

  auto kernel = block_transform_kernel<B, CT, TIn, TOut, AMOUNT>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Shape::kThreads,
                                                           smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long ctas = static_cast<long long>(per_sm) * sms;
  if (max_ctas > 0 && ctas > max_ctas) ctas = max_ctas;
  if (ctas > p.ntiles) ctas = p.ntiles;
  kernel<<<static_cast<unsigned int>(ctas), Shape::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int B, typename TIn, typename TOut, bool AMOUNT>
int launch_c(const Params& p, long long rows, int max_ctas, cudaStream_t stream) {
  switch (p.c) {
    case 1: return launch<B, 1, TIn, TOut, AMOUNT>(p, rows, max_ctas, stream);
    case 3: return launch<B, 3, TIn, TOut, AMOUNT>(p, rows, max_ctas, stream);
    case 4: return launch<B, 4, TIn, TOut, AMOUNT>(p, rows, max_ctas, stream);
    default: return launch<B, 0, TIn, TOut, AMOUNT>(p, rows, max_ctas, stream);
  }
}

template <int B>
int launch_types(const Params& p, long long rows, int in_u8, int out_u8, int max_ctas,
                 cudaStream_t stream) {
  const bool amount = p.amount != nullptr;
  if (in_u8 && out_u8) {
    return amount ? launch_c<B, uint8_t, uint8_t, true>(p, rows, max_ctas, stream)
                  : launch_c<B, uint8_t, uint8_t, false>(p, rows, max_ctas, stream);
  }
  if (!in_u8 && !out_u8) {
    return amount ? launch_c<B, float, float, true>(p, rows, max_ctas, stream)
                  : launch_c<B, float, float, false>(p, rows, max_ctas, stream);
  }
  if (in_u8 && !out_u8 && !amount) {
    return launch_c<B, uint8_t, float, false>(p, rows, max_ctas, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes). x and out hold the same elements
// in the same layout, uint8 (in_u8 / out_u8 = 1) or f32, contiguous on the
// current device:
//   frame = 1: (rows / (H / b) frames, H, W, c) with row_stride = W * c
//              elements; `rows` block rows of `bx` = W / b blocks;
//   frame = 0: (bx, b, b, c) blocks; rows = 1, row_stride unused.
// table (levels, b, b) f32, idx (rows * bx,) int32, amount (levels,) f32 or
// null. `group` blocks make a tile; `max_ctas` > 0 caps the grid. Launches
// on `stream`, does not synchronise, and returns the CUDA error of the set-up
// or of the launch as an int (0 = cudaSuccess).
extern "C" int elvis_block_transform(const void* x, void* out, const float* table,
                                     const int* idx, const float* amount, long long rows,
                                     long long bx, long long row_stride, int frame, int b, int c,
                                     int levels, int in_u8, int out_u8, int group, int max_ctas,
                                     void* stream) {
  if (rows <= 0 || bx <= 0) return 0;
  if (levels < 1 || levels > kMaxLevels || c < 1 || group < 1 || (b != 8 && b != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (frame && (row_stride != bx * b * c || row_stride > 2147483647LL))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!frame && rows != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (group > bx) group = static_cast<int>(bx);
  Params p;
  p.x = x;
  p.out = out;
  p.table = table;
  p.idx = idx;
  p.amount = amount;
  p.bx = bx;
  p.rb_stride = frame ? row_stride * b : 0;
  p.grs = frame ? static_cast<int>(row_stride) : b * c;
  p.bstride = frame ? b * c : b * b * c;
  p.frame = frame ? 1 : 0;
  p.c = c;
  p.levels = levels;
  p.group = group;
  p.pitch_in = p.pitch_out = p.vec = 0;
  p.tiles_per_row = p.ntiles = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b == 8 ? launch_types<8>(p, rows, in_u8, out_u8, max_ctas, s)
                : launch_types<16>(p, rows, in_u8, out_u8, max_ctas, s);
}
