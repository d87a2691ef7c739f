// Column sums in NumPy's order for Hopper (sm_90a):
//
//   out[j] = ((0 + x[0, j]) + x[1, j]) + ... + x[n-1, j]
//
// over a C-ordered (n, cols) array, in its own dtype (f32 or f64), every add
// rounded to nearest on its own.  That is how NumPy's add.reduce over axis 0
// adds a C-ordered array of two or more columns: row after row, from 0.
// Given a centre c, the sums are of d * d, d = x[i, j] - c[j], with d and
// its square each rounded before the add, as np.var rounds them.
//
// Replaces no TPU kernel: the JAX package prepares a scene in host NumPy
// (cmlpl_tpu/data/prep.py), as the port does on the CPU.  The port's device
// prep (data/prep.py) has to reproduce NumPy's column means and standard
// deviations bit for bit: a more accurate sum moves the z-scored spectra by
// up to 2e-4 and flips near-tied labels of a map.  No library reduction adds
// in this order, so the prep's three column passes (the mean, the mean of
// the centred pixels, their squared deviations) run here.
//
// Bound: one chain of n dependent adds a column, which nothing shortens, for
// the order is the result.  At 4 cycles an add that is ~0.42 ms for 207,400
// rows at 1.98 GHz, against ~0.03 ms (f32) or ~0.05 ms (f64) to read the
// matrix at 3.35 TB/s.  So the kernel is latency-bound by design, and what
// it has to do is keep the chain fed:
//
// - a block takes one 32-byte sector of each row (8 f32 or 4 f64 columns),
//   so 103 columns give 13 (f32) or 26 (f64) blocks on as many SMs, each row
//   of a block one full sector;
// - all 256 threads of a block copy tiles of rows into a ring of shared
//   memory with cp.async, a tile or more ahead of the chain, one barrier a
//   tile, while one thread a column runs the chain over the oldest tile;
// - a tile lies column-major in shared memory (each column padded by 16
//   bytes, so the chain threads' reads fall in distinct banks), and a chain
//   thread reads 16 bytes of its column at once: 4 or 2 rows a load;
// - the squares of the centred variant are formed off the chain, each with
//   __fsub_rn / __fmul_rn (or the f64 ones) so that nothing contracts into
//   an FMA with the add.
//
// Of the designs timed at (207,400, 103) on an H100 (a row-major tile
// filled through registers: 1.14 ms f32, 1.39 ms f64; cp.async into a
// row-major ring: 1.16 / 1.44 ms; column-major rings of 256 rows x 4,
// 512 x 2 and 128 x 8: 0.99 / 1.42, 0.77 / 1.41 and 0.86 / 1.26 ms), f32
// takes 512-row tiles in 2 stages and f64 128-row tiles in 8.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a shape it does
// not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSectorBytes = 32;

template <typename T>
struct Elem;

// each dtype's tile ring (rows a tile, tiles in flight, the chain's vector
// load) and its adds, subtracts and multiplies, each rounded to nearest
template <>
struct Elem<float> {
  static constexpr int kRows = 512;
  static constexpr int kStages = 2;
  using Vec = float4;
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
};

template <>
struct Elem<double> {
  static constexpr int kRows = 128;
  static constexpr int kStages = 8;
  using Vec = double2;
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
};

// one element global -> shared, asynchronously; none read (zeros written)
// where !live
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem,
                                           bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = live ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(bytes));
  }
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, bool kCentred>
__global__ void __launch_bounds__(kThreads)
column_sums_seq_kernel(const T* __restrict__ x, const T* __restrict__ centre,
                       T* __restrict__ out, int64_t n, int cols) {
  using R = Elem<T>;
  constexpr int kCw = kSectorBytes / static_cast<int>(sizeof(T));
  constexpr int kRowsPass = kThreads / kCw;     // rows a copy of the block
  constexpr int kPasses = R::kRows / kRowsPass;  // copies a thread a tile
  constexpr int kLd = R::kRows + 16 / static_cast<int>(sizeof(T));
  constexpr int kTile = kCw * kLd;              // elements a stage
  constexpr int kVec = sizeof(typename R::Vec) / sizeof(T);
  __shared__ __align__(16) T ring[R::kStages * kTile];

  const int c = threadIdx.x % kCw;
  const int r = threadIdx.x / kCw;
  const int col = blockIdx.x * kCw + c;
  const bool live = col < cols;
  const T mid = (kCentred && live) ? centre[col] : T(0);
  const int64_t tiles = (n + R::kRows - 1) / R::kRows;

  // tile t into its stage, as one group of copies (empty past the end)
  auto fetch = [&](int64_t t) {
    if (t < tiles) {
      T* stage = ring + (t % R::kStages) * kTile + c * kLd;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int i = p * kRowsPass + r;
        const int64_t row = t * R::kRows + i;
        const bool ok = live && row < n;
        copy_async(stage + i, ok ? x + row * cols + col : x, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto term = [&](T e) {
    if (kCentred) {
      const T d = R::sub(e, mid);
      e = R::mul(d, d);
    }
    return e;
  };

#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) fetch(s);
  T acc = T(0);
  for (int64_t t = 0; t < tiles; ++t) {
    wait_copies<R::kStages - 2>();  // this thread's copies of tile t
    // every thread's copies of tile t have landed, and the chain is done
    // with tile t - 1, whose stage the next fetch refills
    __syncthreads();
    fetch(t + R::kStages - 1);
    if (threadIdx.x < kCw) {  // the chain: one thread a column
      const T* s = ring + (t % R::kStages) * kTile + c * kLd;
      const int64_t left = n - t * R::kRows;
      if (left >= R::kRows) {
#pragma unroll 16
        for (int i = 0; i < R::kRows; i += kVec) {
          const typename R::Vec v =
              *reinterpret_cast<const typename R::Vec*>(s + i);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc = R::add(acc, term(e[j]));
        }
      } else {
        for (int i = 0; i < static_cast<int>(left); ++i)
          acc = R::add(acc, term(s[i]));
      }
    }
  }
  wait_copies<0>();
  if (threadIdx.x < kCw && live) out[col] = acc;
}

template <typename T>
int launch(const void* x, const void* centre, void* out, int64_t n, int cols,
           void* stream) {
  if (n < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kCw = kSectorBytes / static_cast<int>(sizeof(T));
  const unsigned int grid = static_cast<unsigned int>((cols + kCw - 1) / kCw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (centre == nullptr) {
    column_sums_seq_kernel<T, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(out), n, cols);
  } else {
    column_sums_seq_kernel<T, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(centre),
        static_cast<T*>(out), n, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cmlpl_column_sums_seq_f32(const void* x, const void* centre,
                                         void* out, int64_t n, int cols,
                                         void* stream) {
  return launch<float>(x, centre, out, n, cols, stream);
}

extern "C" int cmlpl_column_sums_seq_f64(const void* x, const void* centre,
                                         void* out, int64_t n, int cols,
                                         void* stream) {
  return launch<double>(x, centre, out, n, cols, stream);
}
