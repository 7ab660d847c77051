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
// What bounds it: bytes. The work is a few min / multiply-add operations
// per element, while every element of scat is read once and every element
// of the field written once: 2 x 4 x R x A bytes, 8.4 MB at the flagship
// [515, 2048] and 15.8 MB at GLOBAL [962, 2048], 2.5 / 4.7 us at 3.35 TB/s.
// Both the column pass's output and the row pass's input stay in the 50 MB
// L2. A thread per column walking all R rows (the first design) left the
// card latency-bound: 2048 threads on 16 SMs, R dependent steps each. The
// design spreads each pass over the whole card instead:
//
//   * column pass (steps 1-3): one block of 1024 threads per strip of
//     kStrip = 16 azimuth columns (128 blocks for A = 2048, one per SM;
//     strips of 32 columns, 64 blocks, took 1.4-1.6x as long on an H100).
//     The block copies the strip into shared memory, a warp reading
//     consecutive columns of one row, so the loads are coalesced. Its
//     threads split the rows into 64 segments, one thread per (segment,
//     column). Each segment takes its local suffix min; a warp per column
//     turns the 64 segment minima into each segment's carry (the min over
//     the rows below it) with a shuffle scan; then each thread applies its
//     carry, evaluates h = z0 + slope * (r * dr) (+inf where the slope is
//     not finite) in place, and after one barrier folds rows r-nfold+1 .. r
//     (row 0 standing in above the top edge) from shared memory and writes
//     each element once. A warp holds two segments; their length is made
//     odd, so the two half-warps' rows lie 16 banks apart and a warp's
//     shared-memory reads never share a bank. A strip taller than
//     kStripSmemMax is walked in chunks of rows, bottom to top, carrying
//     the suffix min; each chunk also holds the nfold - 1 rows above it as
//     the fold's halo (their suffix min is known from the chunk's own
//     rows, so the halo is recomputed, not carried). The block's phases
//     (load, suffix min, carry, height, fold and store) run one after
//     another, and at one block per SM nothing overlaps them: the likeliest
//     reason the pass stays well above its share of the bound.
//   * row pass (steps 4-5): one block per range row holds the row's A
//     floats in shared memory (double-buffered, 2*A*4 bytes) and applies
//     lvl[r] circular roll-min doublings h[a] = min(h[a], h[(a + 2^k) % A]),
//     which leave the min over [a, a + 2^lvl - 1]. The exact window's
//     residual shift < 2^lvl then takes one more pass at distance shift
//     (the two windows overlap and cover [a, a + 2^lvl + shift - 1]), not
//     one per set bit of shift as in the reference; the widest rows of the
//     flagship need 10 passes, not 14. The window opens to the right, like
//     jnp.roll(x, -(1 << k)) in the reference. The row's time is the chain
//     of its passes, each a barrier, so 512 threads share a row: 4 floats
//     each at A = 2048. A van Herk / Gil-Werman window min (three sweeps
//     over the row extended by w - 1, two segmented scans across the
//     block, two barriers whatever w) was bit-identical but slower on an
//     H100, at [515, 2048] / [962, 2048]: 12.4 / 21.0 us for every row,
//     8.2 / 9.3 us with only the rows of 9 passes or more, against 6.4 /
//     7.7 us for the passes. Most rows have w <= 16, where three or four
//     passes cost fewer instructions than its sweeps.
// min is exact, so every pass is bit-identical to the reference's whatever
// the order and the grouping of its operands. The one affine evaluation is
// the reference's fused multiply-add z0 + m * d_r, computed as the plain
// twin computes it (numerics.fma_f32): the product exactly in double, one
// double add, one rounding to float. So the result equals the plain
// PyTorch twin bit for bit.
//
// z0 is read from device memory (sensor_origin[2]), so a launch needs no
// host sync and stays capturable in a CUDA graph.
//
// A batch of K fields [K, R, A] (the scan-batched replay step's K scans,
// each with its own sensor height z0[k * z0_stride]) is one launch of each
// kernel: the frame is blockIdx.y, so each block's work is unchanged and
// K = 1 is the single-field launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNfoldMax = 10;  // ceil(1 / range_bin_factor), factor >= 0.1
constexpr int kStrip = 16;            // azimuth columns per column block
constexpr int kColumnThreads = 1024;  // one per (row segment, column)
constexpr int kSegments = kColumnThreads / kStrip;
static_assert(kSegments == 64, "the carry scan gives each lane two segments");
// Shared memory of one column block: the strip chunk, the segment carries
// and the chunk carry. GLOBAL [962, 2048] needs 64 KB.
constexpr int kStripSmemMax = 192 * 1024;
constexpr int kRowThreads = 512;

// jnp.minimum semantics: NaN propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(kColumnThreads)
polar_column_kernel(const float* __restrict__ scat,
                    const float* __restrict__ z0_ptr, int z0_stride, float dr,
                    int R, int A, int nfold, int chunk_rows,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const size_t frame = (size_t)blockIdx.y * R * A;
  scat += frame;
  out += frame;
  const int halo = nfold - 1;
  float* strip = smem;                                  // [chunk + halo][kStrip]
  float* below = strip + (chunk_rows + halo) * kStrip;  // [kStrip][kSegments + 1]
  float* carry = below + kStrip * (kSegments + 1);      // [2][kStrip]

  const int c = threadIdx.x % kStrip;
  const int s = threadIdx.x / kStrip;
  const int a_base = blockIdx.x * kStrip;
  const int a = a_base + c;
  const float z0 = z0_ptr[(size_t)blockIdx.y * z0_stride];
  if (threadIdx.x < kStrip) carry[threadIdx.x] = INFINITY;

  int buf = 0;
  for (int hi = R; hi > 0; hi -= chunk_rows, buf ^= 1) {
    const int lo = max(hi - chunk_rows, 0);
    const int top = max(lo - halo, 0);  // first row held: the halo's
    const int n = hi - top;

#pragma unroll 4
    for (int e = threadIdx.x; e < n * kStrip; e += kColumnThreads) {
      const int ae = a_base + e % kStrip;
      strip[e] = ae < A ? scat[(size_t)(top + e / kStrip) * A + ae] : INFINITY;
    }
    __syncthreads();

    // Step 1: the segment's local suffix min, in place.
    const int L = ((n + kSegments - 1) / kSegments) | 1;  // odd: no bank conflicts
    const int r_begin = min(s * L, n);
    const int r_end = min(r_begin + L, n);
    float m = INFINITY;
    for (int r = r_end - 1; r >= r_begin; --r) {
      m = min_nan(m, strip[r * kStrip + c]);
      strip[r * kStrip + c] = m;
    }
    below[c * (kSegments + 1) + s] = m;
    __syncthreads();

    // Each segment's carry, the min over the rows below it: a suffix scan
    // over the segments' minima, one warp per column (lane l holds
    // segments 2l and 2l + 1), joined with the carry from below the chunk.
    // A column's minima are padded to kSegments + 1 floats, so the writes
    // above and the reads below share a bank at most two ways.
    if (threadIdx.x < 32 * kStrip) {
      const int lane = threadIdx.x % 32;
      float* seg = below + (threadIdx.x / 32) * (kSegments + 1) + 2 * lane;
      const float m1 = seg[1];
      const float m01 = min_nan(seg[0], m1);
      float tot = m01;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, tot, d);
        if (lane + d < 32) tot = min_nan(tot, o);
      }
      float after = __shfl_down_sync(0xffffffffu, tot, 1);
      after = min_nan(lane == 31 ? INFINITY : after, carry[buf * kStrip + threadIdx.x / 32]);
      seg[0] = min_nan(m1, after);
      seg[1] = after;
    }
    __syncthreads();
    const float below_s = below[c * (kSegments + 1) + s];

    // Step 2: apply the carry and evaluate the height in place. The suffix
    // min at the chunk's first row is the next chunk's carry.
    for (int r = r_begin; r < r_end; ++r) {
      const float ms = min_nan(below_s, strip[r * kStrip + c]);
      if (top + r == lo) carry[(buf ^ 1) * kStrip + c] = ms;
      const float d_r = __fmul_rn((float)(top + r), dr);
      strip[r * kStrip + c] =
          isfinite(ms) ? __double2float_rn(__dadd_rn(
                             __dmul_rn((double)ms, (double)d_r), (double)z0))
                       : INFINITY;
    }
    __syncthreads();

    // Step 3: the in-cell fold over rows r-nfold+1 .. r of the chunk's own
    // rows. Local row 0 is global row 0 or the halo's top, which is
    // nfold - 1 rows above the chunk, so the clamp at 0 is the edge rule.
    if (a < A) {
      for (int r = max(r_begin, lo - top); r < r_end; ++r) {
        float acc = strip[r * kStrip + c];
        for (int k = 1; k < nfold; ++k) acc = min_nan(acc, strip[max(r - k, 0) * kStrip + c]);
        out[(size_t)(top + r) * A + a] = acc;
      }
    }
    __syncthreads();
  }
}

// One circular roll-min pass: nxt[a] = min(cur[a], cur[(a + s) % A]),
// 0 <= s < A.
__device__ __forceinline__ void roll_min_pass(const float* cur, float* nxt,
                                              int A, int s) {
#pragma unroll 4
  for (int a = threadIdx.x; a < A; a += kRowThreads) {
    int j = a + s;
    if (j >= A) j -= A;
    nxt[a] = min_nan(cur[a], cur[j]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRowThreads)
polar_row_kernel(float* __restrict__ field, const int* __restrict__ lvl,
                 const int* __restrict__ shift, int A, int exact_window) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + A;
  float* row = field + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * A;

#pragma unroll 4
  for (int a = threadIdx.x; a < A; a += kRowThreads) cur[a] = row[a];
  __syncthreads();

  // After ceil(log2(A)) doublings the window is the whole row.
  const int levels = min(max(lvl[blockIdx.x], 0), A > 1 ? 32 - __clz(A - 1) : 0);
  for (int k = 0; k < levels; ++k) {
    roll_min_pass(cur, nxt, A, 1 << k);
    float* t = cur; cur = nxt; nxt = t;
  }
  const int s = exact_window ? shift[blockIdx.x] : 0;
  if (s > 0 && s <= (1 << levels)) {
    roll_min_pass(cur, nxt, A, s < A ? s : s % A);
    float* t = cur; cur = nxt; nxt = t;
  } else if (s > 0) {  // a table whose shift outgrows 2^lvl: bit by bit
    for (int b = 0; (s >> b) != 0; ++b) {
      if ((s >> b) & 1) {
        roll_min_pass(cur, nxt, A, (1 << b) % A);
        float* t = cur; cur = nxt; nxt = t;
      }
    }
  }
#pragma unroll 4
  for (int a = threadIdx.x; a < A; a += kRowThreads) row[a] = cur[a];
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

int fastdem_polar_field_nfold_max() { return kNfoldMax; }

const char* fastdem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K1 on `stream` over `frames` contiguous [R, A] fields; returns
// the cudaError_t of the launches (0 = ok). All pointers are device
// pointers; nothing is allocated or synchronised.
int fastdem_polar_field(const float* scat, const int* lvl, const int* shift,
                        const float* z0, int z0_stride, int frames, float dr,
                        int R, int A, int nfold, int exact_window, float* out,
                        void* stream) {
  if (R <= 0 || A <= 0 || nfold < 1 || nfold > kNfoldMax || frames <= 0 ||
      frames > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The column pass holds as many rows of its strip as fit, with the halo.
  const int halo = nfold - 1;
  const size_t fixed = (kSegments + 3) * kStrip * sizeof(float);
  const int fit = static_cast<int>((kStripSmemMax - fixed) / (kStrip * sizeof(float))) - halo;
  const int chunk_rows = R < fit ? R : fit;
  size_t smem = fixed + static_cast<size_t>(chunk_rows + halo) * kStrip * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(polar_column_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 column_grid((A + kStrip - 1) / kStrip, frames);
  polar_column_kernel<<<column_grid, kColumnThreads, smem, st>>>(
      scat, z0, z0_stride, dr, R, A, nfold, chunk_rows, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = 2 * static_cast<size_t>(A) * sizeof(float);
  err = set_smem(reinterpret_cast<const void*>(polar_row_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  polar_row_kernel<<<dim3(R, frames), kRowThreads, smem, st>>>(
      out, lvl, shift, A, exact_window);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
