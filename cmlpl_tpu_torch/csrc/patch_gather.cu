// Windowed patch gather for Hopper (sm_90a): out[b] = cube[r:r+w, c:c+w, :]
// with r = idx[b] // cols, c = idx[b] % cols, the start taken as
// lax.dynamic_slice takes it (negative from the end, then clamped).
//
// Replaces the two Pallas TPU kernels of cmlpl_tpu/ops/patch_gather.py:
// _gather_kernel / gather_patches_pallas (f32) and _gather_kernel_shifted /
// gather_patches_pallas_shifted (bf16).  Their 128-lane channel pad, their
// 8 column-shifted bf16 cube copies, the SMEM coordinate blocking and the
// ragged-B pad-and-slice all exist for Mosaic's DMA rules and are not
// carried over: in NHWC one patch row is a single contiguous span of w*C
// elements at a stride of cube_cols*C.  A copy commutes with the element
// type, so the kernels move raw bits (uint32_t for f32, uint16_t for bf16).
//
// Bound: pure data movement, no arithmetic.  Each patch writes w*w*C
// elements once; the reads come from a window of the cube that
// neighbouring patches share, so most of them hit L2.  At the callers'
// sizes (a map tile of 512 patches moves 2-51 MB) what costs time besides
// the bytes is latency: the launch, then one dependent chain per thread
// (read the id, place the window, read the pixels, write) that every
// instruction on it lengthens, times the waves of threads a launch needs.
// The plan (gather_plan in ops/patch_gather.py) picks one of two paths by
// shape:
//
// - rows (wide rows whose pixels are 8-byte multiples, such as f32 and
//   bf16 at w 20, C 60, and small batches of narrow rows): one 128-thread
//   block per (patch, patch row) copies the row with the widest vector
//   that the two addresses and the length allow.  Its chain is the
//   shortest, and rows of kilobytes keep a block busy.
// - groups (the zoo's narrow rows and odd pixel strides at a map tile):
//   blocks of G whole patches, R patch rows a warp.  Against tiny blocks:
//   a block moves G patches, not one row of 65 floats, and a warp R rows,
//   so a map tile's rows need one wave of warps, not several.  Against
//   narrow copies: every read is an aligned 16-byte load whatever the
//   pixel stride, each source chunk loaded once (a lane takes the next
//   lane's by a shuffle and shifts its row's bytes out of the two), and
//   every write a 16-byte store but for a row's two end chunks, masked to
//   its own elements.  Against latency: a warp issues the loads of all its
//   rows before their writes, needs no barrier and no shared memory (lane
//   j reads the id of its row j's patch), and indexes rows in 32 bits.
//   The aligned loads never reach outside the cube's bytes, whose base may
//   be only element-aligned: a source chunk that would loads the cube's
//   elements of it alone.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a plan that
// does not fit the shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPathRows = 0;
constexpr int kPathGroups = 1;
constexpr int kRowThreads = 128;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// lax.dynamic_slice's start: floor division, a negative start counts from
// the end of its axis, then the window is clamped into the cube
__device__ __forceinline__ int2 window_start(int id, int cols, int cube_rows,
                                             int cube_cols, int w) {
  int r = floor_div(id, cols);
  int c = id - r * cols;
  if (r < 0) r += cube_rows;
  if (c < 0) c += cube_cols;
  return make_int2(min(max(r, 0), cube_rows - w),
                   min(max(c, 0), cube_cols - w));
}

// ---------------------------------------------------------------- rows --

template <typename V>
__device__ __forceinline__ void copy_span(const char* __restrict__ src,
                                          char* __restrict__ dst,
                                          int64_t bytes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const int64_t n = bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) d[k] = __ldg(s + k);
}

template <typename U>
__global__ void __launch_bounds__(kRowThreads)
patch_gather_rows_kernel(const U* __restrict__ cube,
                         const int32_t* __restrict__ idx, U* __restrict__ out,
                         int cube_rows, int cube_cols, int channels, int cols,
                         int w) {
  const int64_t blk = blockIdx.x;
  const int64_t b = blk / w;
  const int i = static_cast<int>(blk - b * w);
  const int2 rc = window_start(__ldg(idx + b), cols, cube_rows, cube_cols, w);

  const int64_t row_elems = static_cast<int64_t>(w) * channels;
  const int64_t src_off =
      (static_cast<int64_t>(rc.x + i) * cube_cols + rc.y) * channels;
  const int64_t dst_off = (b * w + i) * row_elems;
  const char* src = reinterpret_cast<const char*>(cube + src_off);
  char* dst = reinterpret_cast<char*>(out + dst_off);
  const int64_t bytes = row_elems * static_cast<int64_t>(sizeof(U));

  const uint64_t align = reinterpret_cast<uint64_t>(src) |
                         reinterpret_cast<uint64_t>(dst) |
                         static_cast<uint64_t>(bytes);
  if ((align & 15) == 0) {
    copy_span<uint4>(src, dst, bytes);
  } else if ((align & 7) == 0) {
    copy_span<uint2>(src, dst, bytes);
  } else if ((align & 3) == 0) {
    copy_span<uint32_t>(src, dst, bytes);
  } else {
    copy_span<U>(src, dst, bytes);
  }
}

// -------------------------------------------------------------- groups --

// the 16 bytes at byte `sub` (a multiple of the element size, < 16) of the
// 32 bytes lo:hi.  `sub` is the same for a whole row, so the switch does
// not diverge; 4-byte elements shift by whole words
template <typename U>
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int sub) {
  uint32_t a0, a1, a2, a3, a4;
  switch (sub >> 2) {
    case 0: a0 = lo.x; a1 = lo.y; a2 = lo.z; a3 = lo.w; a4 = hi.x; break;
    case 1: a0 = lo.y; a1 = lo.z; a2 = lo.w; a3 = hi.x; a4 = hi.y; break;
    case 2: a0 = lo.z; a1 = lo.w; a2 = hi.x; a3 = hi.y; a4 = hi.z; break;
    default: a0 = lo.w; a1 = hi.x; a2 = hi.y; a3 = hi.z; a4 = hi.w; break;
  }
  if constexpr (sizeof(U) == 4) return make_uint4(a0, a1, a2, a3);
  const uint32_t bs = static_cast<uint32_t>(sub & 3) * 8;
  return make_uint4(__funnelshift_r(a0, a1, bs), __funnelshift_r(a1, a2, bs),
                    __funnelshift_r(a2, a3, bs), __funnelshift_r(a3, a4, bs));
}

template <typename U>
union Chunk {
  uint4 v;
  U e[16 / sizeof(U)];
};

template <typename U>
struct Groups {
  uintptr_t lo, hi;  // the cube's bytes
  const int32_t* idx;
  U* out;
  int cube_rows, cube_cols, cols, w, group, row_bytes;
  int rows, groups;  // batch * w, and groups of `group` patches
  int64_t pitch;     // bytes of a cube row
  int pixel;         // bytes of a pixel

  // the aligned 16 bytes of the cube at `at`, zero where they leave it
  __device__ __forceinline__ uint4 load_src(uintptr_t at) const {
    constexpr int kElt = sizeof(U);
    if (at >= lo && at + 16 <= hi)
      return __ldg(reinterpret_cast<const uint4*>(at));
    Chunk<U> pk;
    pk.v = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int e = 0; e < 16 / kElt; ++e)
      if (at + e * kElt >= lo && at + e * kElt < hi)
        pk.e[e] = __ldg(reinterpret_cast<const U*>(at + e * kElt));
    return pk.v;
  }

  // the aligned 16-byte chunks of out that hold any byte of the row at
  // `d0` (none for d0 = 0, no row)
  __device__ __forceinline__ int chunks_of(uint64_t d0) const {
    if (d0 == 0) return -1;
    const uint64_t a0 = d0 & ~static_cast<uint64_t>(15);
    return static_cast<int>(
        (((d0 + row_bytes - 1) & ~static_cast<uint64_t>(15)) - a0) / 16 + 1);
  }

  // chunk `a` of out: whole where the row holds all of it, else the row's
  // elements alone (the neighbouring row writes the rest)
  __device__ __forceinline__ void write(uintptr_t a, uint4 v,
                                        uintptr_t d0) const {
    constexpr int kElt = sizeof(U);
    if (a >= d0 && a + 16 <= d0 + row_bytes) {
      *reinterpret_cast<uint4*>(a) = v;
      return;
    }
    Chunk<U> pk;
    pk.v = v;
#pragma unroll
    for (int e = 0; e < 16 / kElt; ++e)
      if (a + e * kElt >= d0 && a + e * kElt < d0 + row_bytes)
        reinterpret_cast<U*>(a)[e] = pk.e[e];
  }
};

// Groups of G whole patches, R consecutive patch rows a warp: the block is
// (32, ceil(G w / R)) threads, and a grid about the card's size strides
// over the groups.  Lane j < R of a warp reads the id of its row j's patch
// and places the row; the warp takes each row's source and out address by
// a shuffle.  Out chunk c of a row (of the aligned 16-byte chunks of out
// that hold any of its bytes) is the 16 bytes at `sub` of aligned source
// chunks c and c + 1 from `base`: in a round the 32 lanes load 32 source
// chunks, one each, and the first 31 write the out chunks they cover, each
// taking its second source chunk from the next lane by a shuffle.  A warp
// issues the loads of all its R rows, kU rounds each, before their writes,
// so one memory latency covers them; nothing is shared and no barrier
// stands between an id and its copy.
template <typename U, int R>
__global__ void __launch_bounds__(1024)
patch_gather_groups_kernel(Groups<U> p) {
  constexpr int kU = 4 / R;
  const int lane = threadIdx.x;
  // 32-bit row and group indices (the wrapper keeps B w under 2^31): a
  // 64-bit division would sit on the chain from launch to write
  const int group_rows = p.group * p.w;
  for (int g = blockIdx.x; g < p.groups; g += gridDim.x) {
    const int end = min(p.rows, (g + 1) * group_rows);
    const int r0 = g * group_rows + static_cast<int>(threadIdx.y) * R;
    if (r0 >= end) continue;
    uint64_t src = 0, d0 = 0;
    if (lane < R && r0 + lane < end) {
      const int r = r0 + lane;
      const int b = r / p.w;
      const int i = r - b * p.w;
      const int2 rc = window_start(__ldg(p.idx + b), p.cols, p.cube_rows,
                                   p.cube_cols, p.w);
      src = p.lo + (rc.x + i) * p.pitch + rc.y * p.pixel;
      d0 = reinterpret_cast<uintptr_t>(p.out) +
           static_cast<uint64_t>(r) * p.row_bytes;
    }
    uint64_t srcs[R], outs[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      srcs[j] = __shfl_sync(0xffffffffu, src, j);
      outs[j] = __shfl_sync(0xffffffffu, d0, j);
    }
    const int most = p.row_bytes / 16 + 2;  // out chunks of a row, at most
    for (int c0 = 0; c0 < most; c0 += 31 * kU) {
      uint4 v[R][kU];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int chunks = p.chunks_of(outs[j]);
        const uint64_t base =
            (srcs[j] - (outs[j] & 15)) & ~static_cast<uint64_t>(15);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + 31 * u + lane;
          v[j][u] = c <= chunks
                        ? p.load_src(base + 16 * static_cast<uint64_t>(c))
                        : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint64_t a0 = outs[j] & ~static_cast<uint64_t>(15);
        const int chunks = p.chunks_of(outs[j]);
        const int sub = static_cast<int>((srcs[j] - (outs[j] & 15)) & 15);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = c0 + 31 * u + lane;
          uint4 next;
          next.x = __shfl_down_sync(0xffffffffu, v[j][u].x, 1);
          next.y = __shfl_down_sync(0xffffffffu, v[j][u].y, 1);
          next.z = __shfl_down_sync(0xffffffffu, v[j][u].z, 1);
          next.w = __shfl_down_sync(0xffffffffu, v[j][u].w, 1);
          if (lane < 31 && c < chunks)
            p.write(a0 + 16 * static_cast<uint64_t>(c),
                    sub == 0 ? v[j][u] : shift_bytes<U>(v[j][u], next, sub),
                    outs[j]);
        }
      }
    }
  }
}

template <typename U, int R>
int launch_groups(const Groups<U>& p, int grid, cudaStream_t st) {
  const int warps = (p.group * p.w + R - 1) / R;
  patch_gather_groups_kernel<U, R>
      <<<static_cast<unsigned int>(grid), dim3(32, warps), 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The rows path launches a block of kRowThreads per (patch, patch row),
// whatever `grid` says; the groups path launches `grid` blocks of (32,
// ceil(group w / R)) threads
template <typename U>
int launch(const void* cube, const void* idx, void* out, int64_t batch,
           int cube_rows, int cube_cols, int channels, int cols, int w,
           int path, int group, int rows_per_warp, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (path == kPathRows) {
    if (group != 1 || rows_per_warp != 1 ||
        batch * w >= (int64_t{1} << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    patch_gather_rows_kernel<U><<<static_cast<unsigned int>(batch * w),
                                  kRowThreads, 0, st>>>(
        static_cast<const U*>(cube), static_cast<const int32_t*>(idx),
        static_cast<U*>(out), cube_rows, cube_cols, channels, cols, w);
    return static_cast<int>(cudaGetLastError());
  }
  const int R = rows_per_warp;
  if (path != kPathGroups || group < 1 || batch * w >= (int64_t{1} << 31) ||
      (R != 1 && R != 2 && R != 4) ||
      32 * ((static_cast<int64_t>(group) * w + R - 1) / R) > 1024 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups<U> p;
  p.lo = reinterpret_cast<uintptr_t>(cube);
  p.hi = p.lo + static_cast<uintptr_t>(cube_rows) * cube_cols * channels *
                    sizeof(U);
  p.idx = static_cast<const int32_t*>(idx);
  p.out = static_cast<U*>(out);
  p.cube_rows = cube_rows;
  p.cube_cols = cube_cols;
  p.cols = cols;
  p.w = w;
  p.group = group;
  p.rows = static_cast<int>(batch * w);
  p.groups = static_cast<int>((batch + group - 1) / group);
  p.pixel = channels * static_cast<int>(sizeof(U));
  p.pitch = static_cast<int64_t>(cube_cols) * p.pixel;
  p.row_bytes = w * p.pixel;
  return R == 1   ? launch_groups<U, 1>(p, grid, st)
         : R == 2 ? launch_groups<U, 2>(p, grid, st)
                  : launch_groups<U, 4>(p, grid, st);
}

}  // namespace

extern "C" int cmlpl_patch_gather_f32(const void* cube, const void* idx,
                                      void* out, int64_t batch, int cube_rows,
                                      int cube_cols, int channels, int cols,
                                      int w, int path, int group,
                                      int rows_per_warp, int grid,
                                      void* stream) {
  return launch<uint32_t>(cube, idx, out, batch, cube_rows, cube_cols,
                          channels, cols, w, path, group, rows_per_warp, grid,
                          stream);
}

extern "C" int cmlpl_patch_gather_bf16(const void* cube, const void* idx,
                                       void* out, int64_t batch,
                                       int cube_rows, int cube_cols,
                                       int channels, int cols, int w,
                                       int path, int group,
                                       int rows_per_warp, int grid,
                                       void* stream) {
  return launch<uint16_t>(cube, idx, out, batch, cube_rows, cube_cols,
                          channels, cols, w, path, group, rows_per_warp, grid,
                          stream);
}
