// Segmented inclusive prefix composition of int32 affine updates, one
// thread per (lane, column) scan.
//
// Replaces cadence_tpu/ops/replay_pallas.py::_affine_scan_kernel (launched
// by affine_segscan_pallas), the direct form of the parallel-in-time
// replay (ops/assoc.py, impl="segscan"). For every step t of every
// (lane, column):
//
//   (m, a) <- rst[t, l] ? (mul[t, l, c], add[t, l, c])
//                       : (m * mul[t, l, c], a * mul[t, l, c] + add[t, l, c])
//
// mod 2^32, with the carry starting at the identity (1, 0); pm/pa take the
// carry after each step. Same inputs give the same outputs as the TPU
// kernel and as the plain version (ops/assoc_cuda.py), bit for bit:
// the arithmetic is unsigned, so it wraps as the reference's int32 does.
//
// What bounds it: bytes. Each element-step reads mul and add and writes pm
// and pa (16 bytes) against three integer operations, and rst adds 1 byte
// per lane-step, so the card's memory rate sets the least time.
//
// What the design does about it:
// - the planes are time-major [T, L, C]: at step t, consecutive threads
//   hold consecutive (l, c) and read and write consecutive addresses, so
//   every access is coalesced; the few rst bytes a warp needs at a step
//   are one broadcast load;
// - parallelism comes from L x C independent scans (393,216 at the assoc
//   main path's 16,384 lanes x 24 columns), not from T, so each thread
//   walks the whole time axis in registers. The TPU kernel's tb-blocked
//   VMEM carry is not needed, and any T is taken;
// - each thread issues the loads of STEPS steps before it combines them,
//   so several loads per thread are in flight while the carry chain runs.
//
// The launch allocates nothing and returns cudaGetLastError(); the Python
// wrapper (ops/assoc_cuda.py) raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEPS = 8;

__global__ void __launch_bounds__(THREADS)
affine_segscan_kernel(const uint32_t* __restrict__ mul,
                      const uint32_t* __restrict__ add,
                      const uint8_t* __restrict__ rst,
                      uint32_t* __restrict__ pm, uint32_t* __restrict__ pa,
                      int T, int L, int C) {
  const int64_t LC = (int64_t)L * C;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= LC) return;
  const int64_t l = i / C;
  uint32_t m = 1u, a = 0u;
  for (int t0 = 0; t0 < T; t0 += STEPS) {
    uint32_t mv[STEPS], av[STEPS];
    uint8_t rv[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int t = t0 + k;
      if (t < T) {
        const int64_t o = (int64_t)t * LC + i;
        mv[k] = __ldg(mul + o);
        av[k] = __ldg(add + o);
        rv[k] = __ldg(rst + (int64_t)t * L + l);
      }
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int t = t0 + k;
      if (t < T) {
        if (rv[k]) {
          m = mv[k];
          a = av[k];
        } else {
          a = a * mv[k] + av[k];
          m = m * mv[k];
        }
        const int64_t o = (int64_t)t * LC + i;
        pm[o] = m;
        pa[o] = a;
      }
    }
  }
}

}  // namespace

extern "C" {

// Scans mul/add [T, L, C] int32 under rst [T, L] uint8 (nonzero = the step
// begins a segment) into pm/pa [T, L, C] int32. All five are contiguous
// device buffers; pm/pa must not alias the inputs. Returns a cudaError_t.
int cadence_affine_segscan(const void* mul, const void* add, const void* rst,
                           void* pm, void* pa, int T, int L, int C,
                           void* stream, int device) {
  if (T < 0 || L < 0 || C < 0) return (int)cudaErrorInvalidValue;
  const int64_t LC = (int64_t)L * C;
  if (T == 0 || LC == 0) return (int)cudaSuccess;
  const int64_t blocks = (LC + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  affine_segscan_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mul), static_cast<const uint32_t*>(add),
      static_cast<const uint8_t*>(rst), static_cast<uint32_t*>(pm),
      static_cast<uint32_t*>(pa), T, L, C);
  return (int)cudaGetLastError();
}

const char* cadence_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
