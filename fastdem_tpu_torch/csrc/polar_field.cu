// K1: the polar ray field's dense tail, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdem_tpu/ops/pallas_polar.py::_kernel
// (launched by polar_smeared_field_pallas). Input: the scattered min-slope
// table scat f32[R, A] (+inf where no ray ended), per-row azimuth window
// tables lvl / shift int32[R], and the sensor height z0 on the device.
// Output: f32[R, A] where entry (r, a) is the min over the circular window
// [a, a + w(r) - 1] of the range-folded height field, w = 2^lvl + shift
// (w = 2^lvl without exact_window).
//
// Design. The TPU kernel keeps the whole field in VMEM and runs ~30 dense
// passes on it. Here the work splits along the two axes:
//   * column pass (steps 1-3): one thread per azimuth column a, so a warp
//     reads 32 consecutive floats of a row. Loop r = R-1 .. 0 carries the
//     running suffix min and writes h = z0 + slope * (r * dr) (+inf where
//     the slope is not finite); loop r = 0 .. R-1 then writes the in-cell
//     fold, the min over rows r-nfold+1 .. r with row 0 standing in above
//     the top edge, from a register shift window of NFOLD_MAX values. Each
//     thread owns its column, so neither loop synchronises.
//   * row pass (steps 4-5): one block per range row holds the row's A
//     floats in shared memory (double-buffered, 2*A*4 bytes) and applies
//     lvl[r] circular roll-min doublings h[a] = min(h[a], h[(a + 2^k) % A]),
//     then one more at each set bit of shift[r]. The window opens to the
//     right, like jnp.roll(x, -(1 << k)) in the reference.
// min is exact, so every pass is bit-identical to the reference's. The one
// affine evaluation is the reference's fused multiply-add z0 + m * d_r,
// computed as the plain twin computes it (numerics.fma_f32): the product
// exactly in double, one double add, one rounding to float. So the result
// equals the plain PyTorch twin bit for bit.
//
// What bounds it: memory, not arithmetic. The flagship field is [515, 2048]
// f32 = 4.2 MB; the kernel reads scat once and reads and writes the field
// about three times, all of which fits in the 50 MB L2. The column pass
// has only A threads, each walking R rows in sequence, so it is latency
// bound; splitting the rows across threads is left to a later change.
//
// z0 is read from device memory (sensor_origin[2]), so a launch needs no
// host sync and stays capturable in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNfoldMax = 10;  // ceil(1 / range_bin_factor), factor >= 0.1
constexpr int kColumnThreads = 128;
constexpr int kRowThreads = 256;

// jnp.minimum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void polar_column_kernel(const float* __restrict__ scat,
                                    const float* __restrict__ z0_ptr,
                                    float dr, int R, int A, int nfold,
                                    float* __restrict__ out) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  const float z0 = *z0_ptr;

  float m = INFINITY;
  for (int r = R - 1; r >= 0; --r) {
    const size_t i = (size_t)r * A + a;
    m = min_nan(m, scat[i]);
    const float d_r = __fmul_rn((float)r, dr);
    out[i] = isfinite(m) ? __double2float_rn(__dadd_rn(
                               __dmul_rn((double)m, (double)d_r), (double)z0))
                         : INFINITY;
  }

  float win[kNfoldMax];
  const float top = out[a];
#pragma unroll
  for (int j = 0; j < kNfoldMax; ++j) win[j] = top;
  for (int r = 0; r < R; ++r) {
    const size_t i = (size_t)r * A + a;
#pragma unroll
    for (int j = kNfoldMax - 1; j > 0; --j) win[j] = win[j - 1];
    win[0] = out[i];
    float acc = win[0];
#pragma unroll
    for (int j = 1; j < kNfoldMax; ++j) {
      if (j < nfold) acc = min_nan(acc, win[j]);
    }
    out[i] = acc;
  }
}

__device__ __forceinline__ void roll_min_pass(const float* cur, float* nxt,
                                              int A, int s) {
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    int j = a + s;
    if (j >= A) j -= A;  // s < A: lvl <= log2(A/2), shift < 2^lvl
    nxt[a] = min_nan(cur[a], cur[j]);
  }
  __syncthreads();
}

__global__ void polar_row_kernel(float* __restrict__ field,
                                 const int* __restrict__ lvl,
                                 const int* __restrict__ shift, int A,
                                 int exact_window) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + A;
  float* row = field + (size_t)blockIdx.x * A;

  for (int a = threadIdx.x; a < A; a += blockDim.x) cur[a] = row[a];
  __syncthreads();

  const int levels = lvl[blockIdx.x];
  for (int k = 0; k < levels; ++k) {
    roll_min_pass(cur, nxt, A, 1 << k);
    float* t = cur; cur = nxt; nxt = t;
  }
  if (exact_window) {
    const int s = shift[blockIdx.x];
    for (int b = 0; (s >> b) != 0; ++b) {
      if ((s >> b) & 1) {
        roll_min_pass(cur, nxt, A, 1 << b);
        float* t = cur; cur = nxt; nxt = t;
      }
    }
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) row[a] = cur[a];
}

}  // namespace

extern "C" {

int fastdem_polar_field_nfold_max() { return kNfoldMax; }

const char* fastdem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K1 on `stream`; returns the cudaError_t of the launches (0 = ok).
// All pointers are device pointers; nothing is allocated or synchronised.
int fastdem_polar_field(const float* scat, const int* lvl, const int* shift,
                        const float* z0, float dr, int R, int A,
                        int nfold, int exact_window, float* out,
                        void* stream) {
  if (R <= 0 || A <= 0 || nfold < 1 || nfold > kNfoldMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int col_blocks = (A + kColumnThreads - 1) / kColumnThreads;
  polar_column_kernel<<<col_blocks, kColumnThreads, 0, st>>>(
      scat, z0, dr, R, A, nfold, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = 2 * static_cast<size_t>(A) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(polar_row_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  polar_row_kernel<<<R, kRowThreads, smem, st>>>(out, lvl, shift, A,
                                                 exact_window);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
