// Kernels 1 and 2 (patch_gather.cu) as operators of the `cmlpl` namespace,
// for the native runner (native/aoti_host.cpp), which has no Python.
//
// An exported training run with a kernel gather (utils/export.py,
// --gather_impl pallas or pallas_bf16) calls cmlpl::gather_patches_f32 or
// cmlpl::gather_patches_bf16 twice a step inside its while_loop; the
// AOTInductor package calls such an operator through the dispatcher by
// name.  In Python, ops/patch_gather.py registers the same schemas
// (OP_SCHEMAS, held equal to the strings below by a CPU test) with the
// plain gather on the CPU and the ctypes launch on the card; a process
// that runs a package without Python loads this library first
// (ops/_build.op_library builds it with g++ against the installed torch
// and links it to the nvcc-built kernel library).
//
// The CUDA kernel here is the wrappers' contract: the checks of
// ops/patch_gather._check and launch_plan, the plan of gather_plan
// (gather_plan.h, its C++ copy), a launch of the extern "C" entry point of
// the cube's dtype on the current stream, and an error for a refused
// launch.  There is no CPU kernel: a bundle that holds these operators is
// built for the card only (save_run_bundle refuses a cpu one).
#include <ATen/core/Tensor.h>
#include <ATen/cuda/CUDAContextLight.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <string>

#include "gather_plan.h"

extern "C" int cmlpl_patch_gather_f32(const void* cube, const void* idx,
                                      void* out, int64_t batch, int cube_rows,
                                      int cube_cols, int channels, int cols,
                                      int w, int path, int group,
                                      int rows_per_warp, int grid,
                                      void* stream);
extern "C" int cmlpl_patch_gather_bf16(const void* cube, const void* idx,
                                       void* out, int64_t batch,
                                       int cube_rows, int cube_cols,
                                       int channels, int cols, int w,
                                       int path, int group,
                                       int rows_per_warp, int grid,
                                       void* stream);

namespace {

using Entry = int (*)(const void*, const void*, void*, int64_t, int, int,
                      int, int, int, int, int, int, int, void*);

at::Tensor Gather(const at::Tensor& cube, const at::Tensor& idx, int64_t cols,
                  int64_t w, at::ScalarType dtype, Entry entry,
                  const char* name) {
  TORCH_CHECK(cube.scalar_type() == dtype, name, ": cube must be ", dtype,
              ", got ", cube.scalar_type());
  TORCH_CHECK(cube.dim() == 3, name, ": cube must be (rows, cols, C), got ",
              cube.sizes());
  TORCH_CHECK(idx.dim() == 1 && idx.scalar_type() == at::kInt, name,
              ": idx must be a 1-D int32 tensor, got ", idx.scalar_type(),
              " ", idx.sizes());
  TORCH_CHECK(cube.is_cuda() && idx.device() == cube.device(), name,
              ": cube and idx must be on one card, got ", cube.device(),
              " and ", idx.device());
  TORCH_CHECK(0 < w && w <= std::min(cube.size(0), cube.size(1)), name,
              ": window ", w, " does not fit cube ", cube.sizes());
  TORCH_CHECK(cols > 0, name, ": cols must be positive, got ", cols);
  TORCH_CHECK(cube.is_contiguous() && idx.is_contiguous(), name,
              ": cube and idx must be contiguous");
  const int64_t b = idx.size(0);
  const int64_t channels = cube.size(2);
  TORCH_CHECK(std::max({cube.size(0), cube.size(1), channels, b * w,
                        w * w * channels}) < (int64_t{1} << 31),
              name, ": cube ", cube.sizes(), " or ", b, " patches of ", w,
              " rows exceed the kernel's 32-bit dims and grid");
  const c10::cuda::CUDAGuard guard(cube.device());
  at::Tensor out = at::empty({b, w, w, channels}, cube.options());
  if (b == 0) return out;
  const int sms =
      at::cuda::getDeviceProperties(cube.device().index())
          ->multiProcessorCount;
  const cmlpl::GatherPlan plan =
      cmlpl::PlanGather(b, w, channels, cube.element_size(), sms);
  TORCH_CHECK(plan.path >= 0, name, ": no plan for batch ", b, ", w ", w,
              ", channels ", channels);
  const cudaStream_t stream =
      c10::cuda::getCurrentCUDAStream(cube.device().index()).stream();
  const int err = entry(cube.const_data_ptr(), idx.const_data_ptr(),
                        out.mutable_data_ptr(), b,
                        static_cast<int>(cube.size(0)),
                        static_cast<int>(cube.size(1)),
                        static_cast<int>(channels), static_cast<int>(cols),
                        static_cast<int>(w), plan.path, plan.group,
                        plan.rows_per_warp, static_cast<int>(plan.grid),
                        stream);
  TORCH_CHECK(err == 0, name, " launch failed: cudaError_t ", err,
              " (plan path ", plan.path, ", group ", plan.group,
              ", rows_per_warp ", plan.rows_per_warp, ", grid ", plan.grid,
              ")");
  return out;
}

at::Tensor GatherF32(const at::Tensor& cube, const at::Tensor& idx,
                     int64_t cols, int64_t w) {
  return Gather(cube, idx, cols, w, at::kFloat, &cmlpl_patch_gather_f32,
                "cmlpl::gather_patches_f32");
}

at::Tensor GatherBf16(const at::Tensor& cube, const at::Tensor& idx,
                      int64_t cols, int64_t w) {
  return Gather(cube, idx, cols, w, at::kBFloat16, &cmlpl_patch_gather_bf16,
                "cmlpl::gather_patches_bf16");
}

}  // namespace

TORCH_LIBRARY(cmlpl, m) {
  m.def("gather_patches_f32(Tensor cube, Tensor idx, int cols, int w) -> Tensor");
  m.def("gather_patches_bf16(Tensor cube, Tensor idx, int cols, int w) -> Tensor");
}

TORCH_LIBRARY_IMPL(cmlpl, CUDA, m) {
  m.impl("gather_patches_f32", &GatherF32);
  m.impl("gather_patches_bf16", &GatherBf16);
}
