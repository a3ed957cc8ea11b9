"""The L2 read rate B2's wgmma route can draw on one card: blocks that all
stream the same buffer (the packed weight image's size) from L2 into
shared memory, as the kernel's producer warp does, and, beside it, every
thread of a block reading it with 16-byte loads.

    python3 tools/l2_stream.py

Builds its own scratch kernel with nvcc (sm_90a) under ``build/l2_stream``
and prints the card line, then one JSON line per case: the mode (``bulk``:
one thread issuing TMA bulk copies into a ring of ``slots`` x ``slot_kb``
KB with mbarrier completion, the kernel's ring; ``lanes``: the same ring,
each slot's copies issued by a lane of its own; ``ld``: 256 threads of
uint4 loads), the blocks, the megabytes each reads, the time (CUDA events,
median of 5 runs of 3 launches) and the rate in TB/s summed over the
blocks, and per block in GB/s. The buffer is read once before timing, so
it is in L2 (50 MB) when the blocks start.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "l2_stream"
SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ bool try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(sa(bar)), "r"(parity) : "memory");
  return done != 0;
}

// one thread streams bytes from src through S slots of `slot` bytes
__global__ void stream_bulk(const char* src, long long bytes, int slot, int S, float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)S * slot);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(full + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int nq = (int)(bytes / slot);
    for (int q = 0; q < nq; ++q) {
      if (q >= S) while (!try_wait(full + q % S, ((q / S) - 1) & 1)) {}
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(sa(full + q % S)), "r"(slot) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];\n"
                   ::"r"(sa(smem + (size_t)(q % S) * slot)), "l"(src + (size_t)q * slot),
                   "r"(slot), "r"(sa(full + q % S)) : "memory");
    }
    for (int q = nq > S ? nq - S : 0; q < nq; ++q)
      while (!try_wait(full + q % S, (q / S) & 1)) {}
    sink[blockIdx.x] = reinterpret_cast<float*>(smem)[0];
  }
}

// lanes 0..S-1 of one warp each own a slot and stream every S-th chunk
// through it, so that S copies are issued by S threads
__global__ void stream_lanes(const char* src, long long bytes, int slot, int S, float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)S * slot);
  const int lane = threadIdx.x;
  if (lane < S) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sa(full + lane)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (lane < S) {
    const int nq = (int)(bytes / slot);
    int uses = 0;
    for (int q = lane; q < nq; q += S, ++uses) {
      if (uses > 0) while (!try_wait(full + lane, (uses - 1) & 1)) {}
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(sa(full + lane)), "r"(slot) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                   "[%0], [%1], %2, [%3];\n"
                   ::"r"(sa(smem + (size_t)lane * slot)), "l"(src + (size_t)q * slot),
                   "r"(slot), "r"(sa(full + lane)) : "memory");
    }
    if (uses > 0) while (!try_wait(full + lane, (uses - 1) & 1)) {}
    sink[blockIdx.x * 32 + lane] = reinterpret_cast<float*>(smem)[lane];
  }
}

// every thread reads 16-byte words, strided by the block
__global__ void stream_ld(const uint4* src, long long words, float* sink) {
  uint32_t acc = 0;
  for (long long i = threadIdx.x; i < words; i += blockDim.x) {
    uint4 v;
    asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(src + i));
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678u) sink[blockIdx.x] = 1.0f;
}

extern "C" int launch_bulk(const void* src, long long bytes, int slot, int S, int blocks,
                           float* sink, void* stream) {
  const int smem = S * slot + 8 * S;
  cudaError_t e = cudaFuncSetAttribute(stream_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  stream_bulk<<<blocks, 32, smem, (cudaStream_t)stream>>>((const char*)src, bytes, slot, S, sink);
  return (int)cudaGetLastError();
}
extern "C" int launch_lanes(const void* src, long long bytes, int slot, int S, int blocks,
                            float* sink, void* stream) {
  const int smem = S * slot + 8 * S;
  cudaError_t e = cudaFuncSetAttribute(stream_lanes,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stream_lanes<<<blocks, 32, smem, (cudaStream_t)stream>>>((const char*)src, bytes, slot, S,
                                                           sink);
  return (int)cudaGetLastError();
}
extern "C" int launch_ld(const void* src, long long bytes, int blocks, float* sink,
                         void* stream) {
  stream_ld<<<blocks, 256, 0, (cudaStream_t)stream>>>((const uint4*)src, bytes / 16, sink);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("l2_stream: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from nflows_tpu_torch.ops.cuda import _build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "l2_stream.cu").write_text(SOURCE)
    lib_path = OUT / "libl2_stream.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(OUT / "l2_stream.cu")], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.launch_bulk.argtypes = [p, ll, i, i, i, p, p]
    lib.launch_ld.argtypes = [p, ll, i, p, p]
    lib.launch_lanes.argtypes = [p, ll, i, i, i, p, p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sink = torch.zeros(32 * 1024, device=dev)
    # the flagship's packed image: 11.96 MB fp32, 5.98 MB bf16 (10 layers)
    for mb_bytes in (11960320, 5980160):
        buf = torch.randint(0, 255, (mb_bytes,), dtype=torch.uint8, device=dev)
        cases = [("bulk", b, s, kb) for b in (1, 128)
                 for s, kb in ((4, 8), (4, 16), (8, 16), (12, 16), (4, 32), (6, 32), (3, 64))]
        cases += [("lanes", b, s, kb) for b in (1, 128)
                  for s, kb in ((4, 16), (8, 16), (12, 16), (6, 32), (3, 64))]
        cases += [("ld", b, 0, 0) for b in (1, 128)]
        for mode, blocks, slots, kb in cases:
            def run():
                if mode in ("bulk", "lanes"):
                    fn = lib.launch_bulk if mode == "bulk" else lib.launch_lanes
                    code = fn(buf.data_ptr(), mb_bytes, kb * 1024, slots, blocks,
                              sink.data_ptr(), stream)
                else:
                    code = lib.launch_ld(buf.data_ptr(), mb_bytes, blocks, sink.data_ptr(),
                                         stream)
                if code:
                    raise RuntimeError(f"launch failed with cudaError_t {code}")
            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(3):
                    run()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 3)
            ms = sorted(times)[2]
            print(json.dumps(dict(mode=mode, blocks=blocks, slots=slots, slot_kb=kb,
                                  mb_a_block=mb_bytes / 1e6, ms=ms,
                                  tb_per_s=blocks * mb_bytes / ms / 1e9,
                                  gb_per_s_a_block=mb_bytes / ms / 1e6)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
