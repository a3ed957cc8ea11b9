// Shared by the training kernels B10 (maf_train.cu, maf_train_cluster.cu)
// and B12 (mademog_train.cu, mademog_train_cluster.cu): the restore of kept
// activations from a tile's scratch in global memory, and the cotangent of
// the context features through a projection. Activations are
// feature-major, [rows][ROWS + 4] fp32; a block has ROWS * 8 threads.
#pragma once

#include <cuda_runtime.h>

namespace {

// rows x [RS] floats from the block's scratch in global memory into shared
// memory, relu'd on the way if asked. Read past L1: another tile of this
// block wrote the same addresses before.
template <int ROWS>
__device__ __forceinline__ void restore(float* dst, const float* src, int rows, bool relu) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  for (int e = threadIdx.x; e < rows * (RS / 4); e += NT) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(src) + e);
    if (relu) {
      v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
    }
    reinterpret_cast<float4*>(dst)[e] = v;
  }
}

// gc[c][s] += sum_o W[o][c] g[o][s]: the cotangent of the C context
// features through a projection W [H][C]. Each (c, s) belongs to one thread
// in every call, so gc needs no barrier of its own.
template <int ROWS>
__device__ __forceinline__ void context_cotangent(const float* W, const float* g, int H, int C,
                                                  float* gc) {
  constexpr int NT = ROWS * 8, RS = ROWS + 4;
  for (int e = threadIdx.x; e < C * ROWS; e += NT) {
    const int c = e / ROWS, s = e % ROWS;
    float sum = 0.0f;
    for (int o = 0; o < H; ++o) sum += W[o * C + c] * g[o * RS + s];
    gc[c * RS + s] += sum;
  }
}

}  // namespace
