// Tile GEMMs of a thread-block cluster: the training kernels B3 and B4 in
// their cluster layout (nsf_train_cluster.cu), where the CS blocks of a
// cluster share one tile of ROWS = 32 samples.
//
// Every block of the cluster holds a full copy of the tile's activation
// matrices ([features][RS] fp32 in its shared memory, RS = ROWS + 4) and
// owns a slice of the columns of every GEMM output: O is cut into groups of
// four columns and block r of CS owns groups [r G / CS, (r + 1) G / CS),
// G = O / 4 (owned_cols). A block computes only its columns, from its own
// shared memory, and with `exchange` stores them into every block's copy
// through distributed shared memory; a cluster barrier (arrive.release /
// wait.acquire) then separates those stores from their readers. Blocks
// only ever store into another block's shared memory, never load from it,
// and only into the columns they own: a block may read its own columns of
// a matrix that the others are writing.
// - cl_gemm: out = W in (+ bias) for the block's columns, in passes of CW =
//   32 columns. Inside the block the depth is split over the 8 warps (each
//   takes an eighth of every staged chunk's rows), each keeping tile_gemm's
//   register tile (8 samples x 4 columns a lane, 32 x 32 a warp); the 8
//   partial tiles are summed in shared memory before the epilogue. The
//   block's columns of the weights are staged a chunk of KCL rows ahead with
//   cp.async.
// - cl_wgrad, cl_bgrad: the weight and bias gradients of a range of rows o
//   (the block's slice), every k, added into global memory with atomics as
//   tile_wgrad does, four floats an atomic where the rows allow.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_gemm.cuh"

namespace nflows {

namespace cg = cooperative_groups;

namespace cl {
constexpr int ROWS = 32;        // samples of a tile
constexpr int RS = ROWS + 4;    // row stride of the activation matrices
constexpr int NT = ROWS * 8;    // threads of a block
constexpr int NW = NT / 32;     // warps of a block
constexpr int CW = 32;          // output columns a pass
constexpr int KCL = 128;        // weight rows a staged chunk
constexpr int NSTAGE = 2;       // chunks in the staging ring
constexpr int RING = NSTAGE * KCL * CW;
// the block's GEMM buffer: the staging ring, then the warps' partial tiles
// [NW][CW][ROWS] (cl_wgrad lays its blocks out there too)
constexpr int WBUF = RING + NW * CW * ROWS;
}  // namespace cl

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ int cluster_rank() { return (int)cg::this_cluster().block_rank(); }

// columns [c0, c1) of an O-wide output (O a multiple of 4) that block `rank`
// of a cluster of CS owns
__device__ __forceinline__ void owned_cols(int O, int rank, int CS, int& c0, int& c1) {
  const int G = O / 4;
  c0 = 4 * (rank * G / CS);
  c1 = 4 * ((rank + 1) * G / CS);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v into the same place of every other block's copy of a matrix
template <int CS>
__device__ __forceinline__ void push(float* local, float4 v) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
#pragma unroll
  for (unsigned q = 1; q < CS; ++q)
    *reinterpret_cast<float4*>(cluster.map_shared_rank(local, (rank + q) % CS)) = v;
}

// chunk c (rows [c KCL, min((c + 1) KCL, I))) of columns [cc, cc + live) of
// W [I][O] into slot c % NSTAGE of the ring, as one cp.async group
__device__ __forceinline__ void stage_chunk(float* ring, const float* W, int I, int O, int cc,
                                            int live, int c) {
  using namespace cl;
  float* dst = ring + (c % NSTAGE) * KCL * CW;
  const int k0 = c * KCL, kn = min(KCL, I - k0), fv = live / 4;
  for (int e = threadIdx.x; e < kn * fv; e += NT) {
    const int r = e / fv, cv = (e % fv) * 4;
    cp_async16(dst + r * CW + cv, W + (size_t)(k0 + r) * O + cc + cv, 16);
  }
  cp_async_commit();
}

// where column col, samples [s, s + 4) of a partial tile sit: the halves of
// every other group of four columns swapped, so that a quarter-warp's
// float4 stores (two columns, four sample groups) hit distinct banks
__device__ __forceinline__ int partial_at(int col, int s) {
  return col * cl::ROWS + (s ^ (16 * ((col >> 2) & 1)));
}

// acc += rows [k0, k1) of one staged chunk: the warp's contiguous share
template <bool RELU>
__device__ __forceinline__ void cl_chunk_fma(const float* in_c, const float* ws, int k0, int k1,
                                             int s_off, int c_loc, float (&acc)[8][4]) {
  using namespace cl;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float4 a0 = *reinterpret_cast<const float4*>(in_c + k * RS + s_off);
    float4 a1 = *reinterpret_cast<const float4*>(in_c + k * RS + s_off + 16);
    if (RELU) {
      a0.x = fmaxf(a0.x, 0.0f); a0.y = fmaxf(a0.y, 0.0f);
      a0.z = fmaxf(a0.z, 0.0f); a0.w = fmaxf(a0.w, 0.0f);
      a1.x = fmaxf(a1.x, 0.0f); a1.y = fmaxf(a1.y, 0.0f);
      a1.z = fmaxf(a1.z, 0.0f); a1.w = fmaxf(a1.w, 0.0f);
    }
    const float4 b0 = *reinterpret_cast<const float4*>(ws + k * CW + c_loc);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// out[o][s] (= or +=) g(sum_k f(in[k][s]) W[k][o] + bias[o]) for the block's
// columns o of the O-wide output and the tile's samples, with f, g, mask,
// stash, GATE and pre as in tile_gemm (mask, gate and out read at the
// block's own columns only). W is [I][O] in global memory, O a multiple of 4.
// With `exchange` the columns are also stored into every other block of
// the cluster and the routine ends with a cluster barrier; without, they
// stay in this block and it ends with a block barrier. Every block of the
// cluster calls it with the same arguments but its own buffers.
template <int CS, bool GATE = false>
__device__ void cl_gemm(const float* in, int I, const float* __restrict__ W,
                        const float* __restrict__ bias, int O, float* out, bool relu_in,
                        bool relu_out, bool accumulate, bool exchange, float* buf,
                        const float* mask = nullptr, float* stash = nullptr,
                        const float* gate = nullptr, float* pre = nullptr) {
  using namespace cl;
  int c0, c1;
  owned_cols(O, cluster_rank(), CS, c0, c1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_off = (lane & 3) * 4, c_loc = (lane >> 2) * 4;
  const int nch = (I + KCL - 1) / KCL;
  float* part = buf + RING;
  for (int cc = c0; cc < c1; cc += CW) {
    const int live = min(CW, c1 - cc);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    stage_chunk(buf, W, I, O, cc, live, 0);
    for (int c = 0; c < nch; ++c) {
      cp_async_wait_all();
      __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
      if (c + 1 < nch) stage_chunk(buf, W, I, O, cc, live, c + 1);
      if (c_loc < live) {
        const float* ws = buf + (c % NSTAGE) * KCL * CW;
        const float* in_c = in + (size_t)c * KCL * RS;
        const int kn = min(KCL, I - c * KCL), per = (kn + NW - 1) / NW;
        const int k0 = min(kn, warp * per), k1 = min(kn, k0 + per);
        if (relu_in) cl_chunk_fma<true>(in_c, ws, k0, k1, s_off, c_loc, acc);
        else cl_chunk_fma<false>(in_c, ws, k0, k1, s_off, c_loc, acc);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float4*>(part + warp * CW * ROWS +
                                   partial_at(c_loc + j, s_off + 16 * half)) =
            make_float4(acc[4 * half + 0][j], acc[4 * half + 1][j], acc[4 * half + 2][j],
                        acc[4 * half + 3][j]);
    __syncthreads();

    for (int e = tid; e < live * (ROWS / 4); e += NT) {
      const int col = e / (ROWS / 4), s4 = (e % (ROWS / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float4 p =
            *reinterpret_cast<const float4*>(part + w * CW * ROWS + partial_at(col, s4));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      const int oc = cc + col;
      const size_t at = (size_t)oc * RS + s4;
      const float bj = bias ? bias[oc] : 0.0f;
      v.x += bj; v.y += bj; v.z += bj; v.w += bj;
      if (mask) {
        const float4 m = *reinterpret_cast<const float4*>(mask + at);
        v.x = m.x > 0.0f ? v.x : 0.0f; v.y = m.y > 0.0f ? v.y : 0.0f;
        v.z = m.z > 0.0f ? v.z : 0.0f; v.w = m.w > 0.0f ? v.w : 0.0f;
      }
      if constexpr (GATE) {
        if (pre) *reinterpret_cast<float4*>(pre + at) = v;
        const float4 g = *reinterpret_cast<const float4*>(gate + at);
        v.x *= gate_sigmoid(g.x); v.y *= gate_sigmoid(g.y);
        v.z *= gate_sigmoid(g.z); v.w *= gate_sigmoid(g.w);
      }
      float4* dst = reinterpret_cast<float4*>(out + at);
      if (accumulate) {
        const float4 o = *dst;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      if (relu_out) {
        v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
        v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
      }
      *dst = v;
      if (stash) *reinterpret_cast<float4*>(stash + at) = v;
      if (exchange) push<CS>(out + at, v);
    }
    if (cc + CW < c1) __syncthreads();  // the next pass writes the partial tiles
  }
  if (exchange) cluster_sync();
  else __syncthreads();
}

// gW[o * ld + k] += sum_s g[o][s] * in[k][s] over the tile's samples for o in
// [o0, o1) and k < I; g and in are [.][RS] in shared memory. A warp owns a
// block of 32 rows o x 32 rows k, a lane 8 x 4 of them (o = lane / 8 + 4 i,
// k = lane % 8 + 8 j: its float4 loads along s are free of bank conflicts).
// Rows beyond the range are read clamped and not added. Where ld and I are
// multiples of 4 and gW is 16-byte aligned, the warp lays its block out in
// its share of buf's partial-tile area ([32][32] a warp, each row's groups
// of eight columns swapped by row % 4 so that the stores spread over the
// banks) and adds it four floats an atomic (sm_90's float4 atomicAdd), a
// quarter of the atomics. Samples beyond the batch must hold zero
// cotangents. Leaves the ring alone; ends with a block barrier.
__device__ __forceinline__ void cl_wgrad(const float* g, int o0, int o1, const float* in,
                                         int I, float* gW, int ld, float* buf) {
  using namespace cl;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = lane >> 3, lk = lane & 7;
  const int nbk = (I + 31) / 32;
  const int nblocks = ((o1 - o0 + 31) / 32) * nbk;
  const bool wide = ld % 4 == 0 && I % 4 == 0 && reinterpret_cast<uintptr_t>(gW) % 16 == 0;
  float* blk = buf + RING + warp * 32 * 32;
  for (int wb = warp; wb < nblocks; wb += NW) {
    const int obase = o0 + (wb / nbk) * 32, kbase = (wb % nbk) * 32;
    const int ob = obase + lo, kb = kbase + lk;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < ROWS; s += 4) {
      float4 gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        gv[i] = *reinterpret_cast<const float4*>(g + min(ob + 4 * i, o1 - 1) * RS + s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(in + min(kb + 8 * j, I - 1) * RS + s);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i][j] += gv[i].x * a.x + gv[i].y * a.y + gv[i].z * a.z + gv[i].w * a.w;
      }
    }
    if (wide) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) blk[(lo + 4 * i) * 32 + ((lk + 8 * j) ^ (8 * lo))] = acc[i][j];
      __syncwarp();
      for (int e = lane; e < 32 * 8; e += 32) {
        const int r = e / 8, c = (e % 8) * 4, o = obase + r, k = kbase + c;
        if (o < o1 && k < I)
          atomicAdd(reinterpret_cast<float4*>(gW + (size_t)o * ld + k),
                    *reinterpret_cast<const float4*>(blk + r * 32 + (c ^ (8 * (r & 3)))));
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = ob + 4 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + 8 * j;
          if (o < o1 && k < I) atomicAdd(gW + (size_t)o * ld + k, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // buf is free again
}

// gb[o] += sum_s g[o][s] for o in [o0, o1).
__device__ __forceinline__ void cl_bgrad(const float* g, int o0, int o1, float* gb) {
  using namespace cl;
  for (int o = o0 + (int)threadIdx.x; o < o1; o += NT) {
    float sum = 0.0f;
    for (int s = 0; s < ROWS; ++s) sum += g[o * RS + s];
    atomicAdd(gb + o, sum);
  }
}

}  // namespace nflows
