// K4: the per-cell lookup of the polar ray field, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel fastdem_tpu/ops/pallas_resample.py::
// _resample_kernel (launched by resample_min2), which computes
// out[i] = min(field[a0[i], r[i]], field[a1[i], r[i]]) over an [A, R]
// field, and fuses the epilogue the reference runs after it
// (postprocess/raycasting.py polar_resample, mapping/pipeline.py phase_a):
//
//   h          = field[r[i], a0[i]]            (one read: exact_window)
//   h          = min(h, field[r[i], a1[i]])    (two reads: the sparse table)
//   touched[i] = isfinite(h) && in_range[i]
//   ray_min[i] = touched[i] ? h : NaN
//
// The field is in the port's [R, A] layout (row-major, A contiguous): the
// transpose of the TPU kernel's. Cells are whole-map or a sensor-centred
// window; the caller computes their indices, so window offsets never reach
// the host.
//
// Design: one thread per cell. The min is an explicit compare that lets
// NaN through like torch.minimum (fminf would drop it), and NaN is written
// as the canonical quiet NaN, so the kernel equals its plain PyTorch twin
// bit for bit whatever the field holds. Indices are in range by
// construction (resample_indices clamps them); they are not checked here.
//
// What bounds it: memory latency of the scattered field reads. The field
// (4.2 MB flagship [515, 2048], 7.9 MB GLOBAL [962, 2048]) was just written
// by K1 and stays in the 50 MB L2; per cell the kernel streams 13-17 bytes
// of indices and flags and writes 5 bytes, all coalesced.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch.minimum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void resample_kernel(const float* __restrict__ field,
                                const int* __restrict__ a0,
                                const int* __restrict__ a1,
                                const int* __restrict__ r_idx,
                                const uint8_t* __restrict__ in_range,
                                int A, int n, float* __restrict__ ray_min,
                                uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = field + (size_t)r_idx[i] * A;
  float h = __ldg(row + a0[i]);
  if (a1 != nullptr) h = min_nan(h, __ldg(row + a1[i]));
  const bool t = isfinite(h) && in_range[i] != 0;
  ray_min[i] = t ? h : __int_as_float(0x7fc00000);
  touched[i] = t ? 1 : 0;
}

}  // namespace

extern "C" {

const char* fastdem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K4 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; a1 may be null (one read per cell).
// Nothing is allocated or synchronised.
int fastdem_resample(const float* field, const int* a0, const int* a1,
                     const int* r_idx, const uint8_t* in_range, int A, int n,
                     float* ray_min, uint8_t* touched, void* stream) {
  if (A <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  resample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      field, a0, a1, r_idx, in_range, A, n, ray_min, touched);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
