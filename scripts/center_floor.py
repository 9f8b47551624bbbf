#!/usr/bin/env python3
"""The floor under the port's one-launch centring path, on the card.

    python3 scripts/center_floor.py

For a batch of (n, m) blocks, times (device time, torch.profiler) three
kernels: a copy of each block through shared memory by one block of 1024
threads (what any one-block-per-matrix design must at least do), a flat
copy over the whole grid (what a pass without reductions costs), and the
port's ``center_op``. The two copy kernels are built here with nvcc into
build/center_floor/. Prints one JSON line per shape, then the card's
nvidia-smi name and power limit. Needs one NVIDIA card and nvcc.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(1024)
copy_via_smem(const float4* k, float4* out, int per_block) {
  extern __shared__ float4 sh[];
  const float4* src = k + (size_t)blockIdx.x * per_block;
  for (int e = threadIdx.x; e < per_block; e += 1024) sh[e] = src[e];
  __syncthreads();
  float4* o = out + (size_t)blockIdx.x * per_block;
  for (int e = threadIdx.x; e < per_block; e += 1024) o[e] = sh[e];
}
__global__ void copy_flat(const float4* k, float4* out, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x)
    out[i] = k[i];
}
extern "C" int floor_copy(const float* k, float* out, int z, int nm,
                          int via_smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (via_smem) {
    cudaFuncSetAttribute(copy_via_smem,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, nm * 4);
    copy_via_smem<<<z, 1024, nm * 4, s>>>((const float4*)k, (float4*)out,
                                          nm / 4);
  } else {
    const long long n4 = (long long)z * nm / 4;
    const int blocks = (int)((n4 + 255) / 256 < 2112 ? (n4 + 255) / 256
                                                      : 2112);
    copy_flat<<<blocks, 256, 0, s>>>((const float4*)k, (float4*)out, n4);
  }
  return (int)cudaGetLastError();
}
"""


def device_ms(torch, fn, iters: int = 50) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("center_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import center_op
    from repro_torch.kernels._build import nvcc_path
    out_dir = ROOT / "build" / "center_floor"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "floor.cu").write_text(SOURCE)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(out_dir / "libfloor.so"), str(out_dir / "floor.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out_dir / "libfloor.so"))
    lib.floor_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.floor_copy.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for z, n, m in ((20, 100, 100), (500, 100, 100), (1, 2000, 2000)):
        k = torch.rand((z, n, m), device="cuda")
        out = torch.empty_like(k)
        row = dict(shape=[z, n, m], center_op_ms=device_ms(
            torch, lambda: center_op(k)))
        row["copy_flat_ms"] = device_ms(torch, lambda: lib.floor_copy(
            k.data_ptr(), out.data_ptr(), z, n * m, 0, stream))
        if n * m * 4 <= 200 * 1024:
            row["copy_via_smem_ms"] = device_ms(torch, lambda: lib.floor_copy(
                k.data_ptr(), out.data_ptr(), z, n * m, 1, stream))
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
