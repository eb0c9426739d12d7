// Shared constants of the vocab kernels (the bf16 cross entropy of
// csrc/ce_fwd.cu and csrc/ce_bwd.cu through csrc/ce_online.cuh, and the
// K6 kernels of csrc/topk.cu and csrc/topk_wide_mma.cu): the widest D the
// tuned kernels take and the TPU kernels' running-max start.

#pragma once

namespace ce {

constexpr int kMaxD = 256;     // the tuned kernels' widest D
constexpr float NEG = -1e30f;  // the TPU kernels' running-max start

}  // namespace ce
