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
// transpose of the TPU kernel's. The kernel, lookup_kernel, also computes
// each cell's indices (a0, a1, r_idx, in_range), which the reference
// computes in resample_indices (fastdem_tpu/postprocess/raycasting.py):
// cell centre, hypot, azimuth, range bin, azimuth half-width, window width
// and level, window start. It reads the map position, the sensor origin and
// the window's top-left cell (r0, c0) from device memory, so a launch needs
// no host sync and stays capturable in a CUDA graph, and it writes ray_min
// and touched and nothing else.
//
// Every f32 operation of the index math is the one the plain twin's
// separate PyTorch ops perform, in the same order: written with the
// round-to-nearest intrinsics, so nvcc contracts nothing into an FMA; the
// reference's fused multiply-adds emulated as the twin does
// (numerics.fma_f32: the product exactly in double, one double add, one
// rounding to f32); atan2f and log2f from CUDA's math library, which
// PyTorch's CUDA kernels call; the f32 -> int32 cast saturating with NaN to
// 0 (geometry.to_i32); the int32 remainder with Python's sign rule
// (torch.remainder). Every constant arrives from the host as the f32 value
// the twin uses. So the kernel equals its twin bit for bit, NaN and touched
// sets included. The min is an explicit compare that lets NaN through like
// torch.minimum (fminf would drop it); NaN is written as the canonical
// quiet NaN.
//
// What bounds it: bytes. Per cell the main-path form reads the field once
// (4 bytes, twice with two reads) and writes 5 bytes: 9 bytes/cell, 2.1 MB
// for the GLOBAL 484 x 484 window, 0.63 us at 3.35 TB/s; its ~100 f32
// operations per cell (two atan2f among them) take less at 67 TFLOP/s.
// One thread per cell, the field reads scattered but L2-resident (K1 has
// just written the 4.2-7.9 MB field), the outputs coalesced.
//
// A batch of K frames (the scan-batched replay step's K scans: fields
// [K, R, A], one map position, sensor origin and window offset per frame)
// is one launch: the frame is blockIdx.y, and K = 1 is the single-frame
// launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// torch.minimum / torch.maximum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// numerics.fma_f32: a * b + c with the product exact in double, one double
// add and one rounding to f32.
__device__ __forceinline__ float fma_emul(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// geometry.to_i32: truncation, saturating out of range, NaN to 0.
__device__ __forceinline__ int to_i32(float x) {
  if (x >= 2147483648.0f) return INT_MAX;
  if (x < -2147483648.0f) return INT_MIN;
  if (isnan(x)) return 0;
  return (int)x;
}

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.remainder on int32: the result takes the divisor's sign.
__device__ __forceinline__ int py_mod(int x, int m) {
  const int r = x % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

__device__ __forceinline__ void store(float h, bool in_range, int i,
                                      float* ray_min, uint8_t* touched) {
  const bool t = isfinite(h) && in_range;
  ray_min[i] = t ? h : __int_as_float(0x7fc00000);
  touched[i] = t ? 1 : 0;
}

}  // namespace

extern "C" {

// Host constants of one polar geometry's lookup, each the f32 value the
// plain twin (ops/resample.py lookup_indices) computes with.
struct FastdemLookup {
  int R, A;          // the field is [R, A]
  int wr, wc;        // the cells: wr x wc from the window's top-left cell
  int two_reads;     // 0: one read (exact_window), 1: min of two reads
  float half_x;      // 0.5 * rows * resolution
  float half_y;      // 0.5 * cols * resolution
  float res;         // resolution
  float half_res;    // resolution * 0.5
  float inv_dr;      // recip_f32(dr)
  float dr;          // dr
  float az_half;     // resolution * AZ_HALF_WIDTH
  float d_min;       // 1e-6, the floor of the cell distance
  float inv_bin;     // recip_f32(2 pi / A)
  float pi;          // pi
  float inv_2pi;     // recip_f32(2 pi)
  float a_f;         // A
  float r_max;       // (R - 1) * dr
};

}  // extern "C"

namespace {

__global__ void lookup_kernel(const float* __restrict__ field,
                              const float* __restrict__ position,
                              const float* __restrict__ sensor_origin,
                              int pos_stride, int so_stride,
                              int pos_frame_stride, int so_frame_stride,
                              const int* __restrict__ r0_ptr,
                              const int* __restrict__ c0_ptr, FastdemLookup p,
                              float* __restrict__ ray_min,
                              uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.wr * p.wc) return;
  const int f = blockIdx.y;
  field += (size_t)f * p.R * p.A;
  position += (size_t)f * pos_frame_stride;
  sensor_origin += (size_t)f * so_frame_stride;
  ray_min += (size_t)f * p.wr * p.wc;
  touched += (size_t)f * p.wr * p.wc;
  const int wi = i / p.wc;
  const int row = (r0_ptr != nullptr ? __ldg(r0_ptr + f) : 0) + wi;
  const int col = (c0_ptr != nullptr ? __ldg(c0_ptr + f) : 0) + (i - wi * p.wc);

  // Cell centre o - (i + 0.5) * res, one fused multiply-add.
  const float ox = __fadd_rn(__ldg(position), p.half_x);
  const float oy = __fadd_rn(__ldg(position + pos_stride), p.half_y);
  const float cx = fma_emul(-__fadd_rn((float)row, 0.5f), p.res, ox);
  const float cy = fma_emul(-__fadd_rn((float)col, 0.5f), p.res, oy);
  const float ddx = __fsub_rn(cx, __ldg(sensor_origin));
  const float ddy = __fsub_rn(cy, __ldg(sensor_origin + so_stride));

  // hypot as the reference computes it: max * sqrt(fma(q, q, 1)).
  const float x = fabsf(ddx), y = fabsf(ddy);
  const float hi = max_nan(x, y), lo = min_nan(x, y);
  const float q = __fdiv_rn(lo, hi == 0.0f ? 1.0f : hi);
  const float root = __double2float_rn(__dsqrt_rn((double)fma_emul(q, q, 1.0f)));
  float dist = hi == 0.0f ? hi : __fmul_rn(hi, root);
  if (x == INFINITY || y == INFINITY) dist = INFINITY;
  const float cell_az = atan2f(ddy, ddx);

  // Far-edge range bin, then the cell's azimuth window at that range.
  const float far = __fadd_rn(dist, p.half_res);
  const int r_idx = clamp_i(to_i32(__fmul_rn(far, p.inv_dr)), 0, p.R - 1);
  const float d_cell = __fmul_rn((float)r_idx, p.dr);
  const float half_w = atan2f(p.az_half, d_cell < p.d_min ? p.d_min : d_cell);
  const int w_bins = clamp_i(
      to_i32(ceilf(__fmul_rn(__fmul_rn(half_w, p.inv_bin), 2.0f))) + 1, 1, p.A / 2);
  const int lvl = to_i32(floorf(log2f((float)(w_bins < 1 ? 1 : w_bins))));
  const int w_pow = 1 << lvl;
  const int a_center = clamp_i(
      to_i32(floorf(__fmul_rn(__fmul_rn(__fadd_rn(cell_az, p.pi), p.inv_2pi), p.a_f))),
      0, p.A - 1);
  const int a0 = py_mod(a_center - w_bins / 2, p.A);

  const float* frow = field + (size_t)r_idx * p.A;
  float h = __ldg(frow + a0);
  if (p.two_reads) h = min_nan(h, __ldg(frow + py_mod(a0 + w_bins - w_pow, p.A)));
  store(h, far <= p.r_max, i, ray_min, touched);
}

}  // namespace

extern "C" {

const char* fastdem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the main path's K4, the lookup with its index math, on `stream`
// over `frames` frames. `p` is a host struct; the fields [frames, R, A]
// (contiguous), position f32[frames, 2] and sensor_origin f32[frames, 3]
// (each with its element and frame strides), r0 / c0 (int32[frames], both
// null for the whole map) and the outputs [frames, wr, wc] are device
// pointers.
int fastdem_resample_lookup(const float* field, const float* position,
                            const float* sensor_origin, int pos_stride,
                            int so_stride, int pos_frame_stride,
                            int so_frame_stride, int frames, const int* r0,
                            const int* c0, const FastdemLookup* p,
                            float* ray_min, uint8_t* touched, void* stream) {
  if (p->R <= 0 || p->A <= 0 || p->wr <= 0 || p->wc <= 0 || frames <= 0 ||
      frames > 65535 || (r0 == nullptr) != (c0 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(p->wr) * p->wc;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads), frames);
  lookup_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      field, position, sensor_origin, pos_stride, so_stride, pos_frame_stride,
      so_frame_stride, r0, c0, *p, ray_min, touched);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
