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
// elements at a stride of cube_cols*C, so the copy needs none of them.
//
// Bound: pure data movement.  Each patch writes w*w*C elements once; the
// reads come from a window of the cube that neighbouring patches share, so
// most of them hit L2.  One block copies one (patch, patch row) span with
// the widest vector (16, 8 or 4 bytes, else one element) that the span
// length and both base addresses allow; offsets are 64-bit.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename V>
__device__ __forceinline__ void copy_span(const char* __restrict__ src,
                                          char* __restrict__ dst,
                                          int64_t bytes) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const int64_t n = bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) d[k] = __ldg(s + k);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
patch_gather_kernel(const T* __restrict__ cube, const int32_t* __restrict__ idx,
                    T* __restrict__ out, int cube_rows, int cube_cols,
                    int channels, int cols, int w) {
  const int64_t blk = blockIdx.x;
  const int64_t b = blk / w;
  const int i = static_cast<int>(blk - b * w);

  // lax.dynamic_slice's start: floor division, a negative start counts
  // from the end of its axis, then the window is clamped into the cube
  const int id = __ldg(idx + b);
  int r = floor_div(id, cols);
  int c = id - r * cols;
  if (r < 0) r += cube_rows;
  if (c < 0) c += cube_cols;
  r = min(max(r, 0), cube_rows - w);
  c = min(max(c, 0), cube_cols - w);

  const int64_t row_elems = static_cast<int64_t>(w) * channels;
  const int64_t src_off =
      (static_cast<int64_t>(r + i) * cube_cols + c) * channels;
  const int64_t dst_off = (b * w + i) * row_elems;
  const char* src = reinterpret_cast<const char*>(cube + src_off);
  char* dst = reinterpret_cast<char*>(out + dst_off);
  const int64_t bytes = row_elems * static_cast<int64_t>(sizeof(T));

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
    copy_span<T>(src, dst, bytes);
  }
}

template <typename T>
int launch(const void* cube, const void* idx, void* out, int64_t batch,
           int cube_rows, int cube_cols, int channels, int cols, int w,
           void* stream) {
  const int64_t blocks = batch * w;
  if (blocks > 0) {
    patch_gather_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(cube), static_cast<const int32_t*>(idx),
        static_cast<T*>(out), cube_rows, cube_cols, channels, cols, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cmlpl_patch_gather_f32(const void* cube, const void* idx,
                                      void* out, int64_t batch, int cube_rows,
                                      int cube_cols, int channels, int cols,
                                      int w, void* stream) {
  return launch<float>(cube, idx, out, batch, cube_rows, cube_cols, channels,
                       cols, w, stream);
}

extern "C" int cmlpl_patch_gather_bf16(const void* cube, const void* idx,
                                       void* out, int64_t batch, int cube_rows,
                                       int cube_cols, int channels, int cols,
                                       int w, void* stream) {
  return launch<__nv_bfloat16>(cube, idx, out, batch, cube_rows, cube_cols,
                               channels, cols, w, stream);
}
