// The launch plan of the patch-gather kernels (patch_gather.cu), for the
// C++ operators of gather_ops.cpp: the C++ copy of
// ops/patch_gather.py's gather_plan and groups_plan, with the same
// constants.  Plain C++ with no CUDA or torch header, so a CPU test
// builds it with g++ and holds it to the Python plan at every shape it
// sweeps (tests/test_torch_port_train_bundle_per_step.py).
#pragma once

#include <algorithm>
#include <cstdint>

namespace cmlpl {

constexpr int kPlanRows = 0;     // a block per patch row
constexpr int kPlanGroups = 1;   // blocks of G whole patches, R rows a warp
constexpr int kPlanRowThreads = 128;
constexpr int64_t kRowsMinBytes = 2048;
constexpr int64_t kMaxBlockThreads = 1024;
constexpr int64_t kMaxThreadsPerSm = 2048;
constexpr int64_t kSmallRows = 2048;

struct GatherPlan {
  int path;
  int group;
  int rows_per_warp;
  int64_t grid;
};

// Threads of a block of `plan` for windows of `w`.
inline int64_t PlanBlockThreads(const GatherPlan& plan, int64_t w) {
  if (plan.path == kPlanRows) return kPlanRowThreads;
  return 32 * ((plan.group * w + plan.rows_per_warp - 1) /
               plan.rows_per_warp);
}

// The launch of a (batch, w, w, channels) gather of `elt_bytes` elements
// on a card of `sms` SMs; path -1 where Python's gather_plan raises.
inline GatherPlan PlanGather(int64_t batch, int64_t w, int64_t channels,
                             int64_t elt_bytes, int64_t sms) {
  const GatherPlan none{-1, 0, 0, 0};
  if (std::min({batch, w, channels, elt_bytes, sms}) < 1) return none;
  const int64_t row = w * channels * elt_bytes;
  const int64_t chunks = row / 16 + 2;
  const bool small = batch * w < kSmallRows;
  if (w > 32 || (row >= kRowsMinBytes && channels * elt_bytes % 8 == 0) ||
      (small && chunks <= 62))
    return GatherPlan{kPlanRows, 1, 1, batch * w};
  const int per_warp = small ? 1 : chunks <= 31 ? 4 : 2;
  const int64_t group =
      small ? 1
            : std::min<int64_t>(chunks > 62 ? 4 : 2,
                                std::max<int64_t>(1, 32 * per_warp / w));
  GatherPlan plan{kPlanGroups, static_cast<int>(group), per_warp, 1};
  const int64_t threads = PlanBlockThreads(plan, w);
  if (threads > kMaxBlockThreads) return none;
  plan.grid = std::min((batch + group - 1) / group,
                       sms * std::max<int64_t>(1, kMaxThreadsPerSm / threads));
  return plan;
}

}  // namespace cmlpl
