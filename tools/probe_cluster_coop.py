#!/usr/bin/env python3
"""Does the CUDA runtime launch clusters of 16 CTAs cooperatively?

The fused stack K4 (``src/repro_torch/kernels/csrc/lstm_stack.cu``)
separates its phases with a grid barrier, so every block of its grid must
be resident at once, and runs its recurrences on non-portable clusters of
16 CTAs.  This probe builds a tiny kernel of K4's block shape (512 threads,
K4's resident shared memory, clusters of 16) that passes a cluster barrier
and then K4's grid barrier a few times, and launches it with
``cudaLaunchKernelEx``:

* cooperative, at as many clusters as cudaOccupancyMaxActiveClusters
  reports: is the pair of attributes accepted, and does the barrier pass;
* cooperative, one cluster more: does the runtime refuse a grid that
  cannot be resident (or, if it takes it, does the barrier time out);
* not cooperative, at the occupancy count.

Every spin gives up after two seconds (the global timer), so a grid that
is not all resident ends in a reported timeout, never a hang.  Card only:

    python3 tools/probe_cluster_coop.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__device__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// K4's grid barrier, giving up after `limit` ns (status 1)
__global__ void __launch_bounds__(512, 1) probe(unsigned int* bar, int rounds,
                                                 int* status) {
  extern __shared__ unsigned char smem[];
  smem[threadIdx.x] = 0;
  cg::this_cluster().sync();
  for (int r = 0; r < rounds; ++r) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int n = gridDim.x;
      const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u;
      __threadfence();
      const unsigned int old = atomicAdd(bar, add);
      const unsigned long long t0 = now_ns();
      while (((old ^ *(volatile unsigned int*)bar) & 0x80000000u) == 0) {
        if (now_ns() - t0 > 2000000000ull) {
          atomicExch(status, 1);
          break;
        }
      }
      __threadfence();
    }
    __syncthreads();
  }
}

static cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int clusters,
                                 int C, size_t smem, int coop) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 2 : 1;
  return cfg;
}

static int prepare(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      probe, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

extern "C" int probe_active(int C, int smem) {
  int rc = prepare(smem);
  if (rc) return -rc;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(attr, 1, C, smem, 0);
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, probe, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int probe_launch(int clusters, int C, int smem, int coop,
                            int rounds, void* bar, void* status) {
  int rc = prepare(smem);
  if (rc) return rc;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(attr, clusters, C, smem, coop);
  cudaError_t e = cudaLaunchKernelEx(&cfg, probe, (unsigned int*)bar,
                                     rounds, (int*)status);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceSynchronize();
  return (int)e;
}
"""


def main() -> int:
    import torch

    from repro_torch.kernels import build, lstm_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = build.BUILD_DIR / "probe_cluster_coop"
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "probe.cu", out / "libprobe.so"
    src.write_text(SOURCE)
    subprocess.run([build.cuda_tool(), *build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_active.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.probe_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    C = lstm_cell.RESIDENT_CLUSTER
    smem = lstm_cell.stack_smem(512, lstm_cell.RESIDENT_MAX_ROWS)
    active = lib.probe_active(C, smem)
    print(f"[probe] {torch.cuda.get_device_name(0)}: clusters of {C} CTAs x "
          f"512 threads, {smem} B of shared memory: "
          f"cudaOccupancyMaxActiveClusters {active}", flush=True)
    for clusters, coop in ((max(active, 1), 1), (max(active, 1) + 1, 1),
                           (max(active, 1), 0)):
        bar = torch.zeros(1, dtype=torch.int32, device="cuda")
        status = torch.zeros(1, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        rc = lib.probe_launch(clusters, C, smem, coop, 4, bar.data_ptr(),
                              status.data_ptr())
        timed_out = int(status.item()) if rc == 0 else None
        print(f"[probe] {clusters} clusters, cooperative={bool(coop)}: "
              f"launch rc {rc}, grid barrier timed out: {timed_out}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
