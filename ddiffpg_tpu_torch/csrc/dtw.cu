// DTW distances between pairs of trajectory tracks, one warp a pair.
//
// Replaces the XLA wavefront of the JAX package (ddiffpg_tpu/ops/dtw.py,
// dtw_pair :25 vmapped by dtw_batch_gather :67), a lax.scan over the 2L-1
// anti-diagonals of each pair's DP table
//
//     D[i, j] = |a_i - b_j|^2 + min(D[i-1, j], D[i, j-1], D[i-1, j-1]),
//
// whose every step reads and writes the [P, L] diagonals in device memory.
//
// What bounds it: operations. A pair's two tracks are at most 12 KB and
// the stacked tracks of a recluster sit in L2, so bytes are few; the work
// is ~8 float32 instructions a cell (Dx subtractions, Dx products, Dx-1
// sums, two minimums, the add; chip_smoke.py:dtw_bound) over sum(la * lb)
// cells. What stands in its way is the DP's serial chain: cell (i, j)
// needs (i-1, j), (i, j-1) and (i-1, j-1).
//
// The design keeps the chain inside registers and one warp:
//   - A warp a pair, several pairs a block; no block-wide barrier at all.
//   - Lane k owns a strip of r = ceil(la / 32) consecutive rows (r <= R,
//     R a template value in {1, 2, 4, 8, 16} chosen per launch from L),
//     and keeps its rows' track points and its last column's r cells in
//     registers. Each r in 1..R has its own code, chosen once a pair, so
//     no row of a strip is predicated off (predicated rows cost as much
//     issue as real ones, plus a register move each).
//   - The columns sweep across the lanes as a wavefront: lane k does
//     column j = s - k at step s, its r cells top to bottom. The cell
//     above its strip, D[top-1, j], is lane k-1's bottom cell of the step
//     before, passed by __shfl_up_sync; D[top-1, j-1] is the value passed
//     the step before that. A pair takes lb + 31 steps at most (against
//     la + lb - 1 block barriers of a thread-a-row layout), and every
//     working lane does its r cells each step.
//   - Each warp copies b into its own shared memory, one coordinate at a
//     time, so that at step s lane k reads b[s - k] and neighbouring lanes
//     read neighbouring words (no bank conflict).
//   - The chain a step is r dependent (min, add) pairs: the minimum is
//     taken as min(up, min(left, diag)), which is exact in any order, so
//     min(left, diag) and the cost are off the chain; row q+1's
//     min(left, diag) is taken before row q's cell overwrites its left
//     value, so each cell is written in place, with no register move.
//   - What is left is issue: ~8 instructions a cell and ~20 a step, on
//     the FP32 and ALU pipes, and -fmad=false leaves no FMA, so the card's
//     float32 peak (which counts an FMA as two flops) is out of reach by
//     half at least.
// Rows at or past la (the strip of the lane holding row la-1, and idle
// lanes) compute cells no valid cell reads: values only flow down and to
// the right. Cell (0, 0) gets 0 as its diagonal, so min(inf, min(inf, 0))
// = 0 and it is cost + 0, as the plain version's best = 0.
//
// Arithmetic follows the plain version (dtw_wavefront in ops/dtw.py) op by
// op: the cost summed over the point's coordinates in index order, then
// cost + best, 3.4e38 off the table, sqrt at the end (sqrtf rounds
// correctly, as torch.sqrt does on the card). Built with -fmad=false, so
// no a*b+c is contracted, and the results are bitwise the plain
// version's. The minimum propagates NaN as torch.minimum and
// jnp.minimum do (fminf would drop it).
//
// Plain C interface for ctypes; the launch returns the CUDA error code.
// With -DDTW_HOST the file is host C++ (tests/test_torch_dtw_host.py): the
// CUDA qualifiers are empty, a warp's 32 lanes run each step in turn, and
// __shfl_up_sync is an array that every lane writes before any lane reads.

#ifdef DTW_HOST
#define __global__
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
#include <math.h>
#include <vector>
#else
#include <cuda_runtime.h>
#endif

#define MAX_L 512
#define MAX_D 3
#define MAX_WARPS 8

namespace {

constexpr int kWarp = 32;
constexpr float kInf = 3.4e38f;

// min(x, y), NaN if either is NaN (torch.minimum, jnp.minimum)
__device__ __forceinline__ float min_nan(float x, float y) {
#ifdef DTW_HOST
  if (x != x) return x;
  if (y != y) return y;
  return y < x ? y : x;
#else
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
#endif
}

// One pair's shape, the same for all lanes of its warp.
struct Pair {
  const float* a;   // track a, [la, D]
  const float* b;   // track b, [lb, D]
  int la, lb;
  int r;            // rows a lane (its strip): ceil(la / 32)
  int last;         // the lane that holds row la - 1
  int steps;        // lb + last: the last lane's column lb - 1 is the end
};

__device__ __forceinline__ Pair pair_at(
    const float* stack_a, const float* stack_b, const int* len_a,
    const int* len_b, const int* ia, const int* ib, int p, int L, int D) {
  Pair g;
  const int ra = __ldg(ia + p), rb = __ldg(ib + p);
  g.la = __ldg(len_a + ra);
  g.lb = __ldg(len_b + rb);
  g.a = stack_a + (size_t)ra * L * D;
  g.b = stack_b + (size_t)rb * L * D;
  g.r = (g.la + kWarp - 1) / kWarp;
  g.last = (g.la - 1) / g.r;
  g.steps = g.lb + g.last;
  return g;
}

// b, [lb, D] point-major, into the warp's shared copy, coordinate-major:
// sb[c * L + j]. `lane` of `stride` lanes copies its share.
template <int D>
__device__ __forceinline__ void copy_b(float* sb, const Pair& g, int L,
                                       int lane, int stride) {
  for (int idx = lane; idx < g.lb * D; idx += stride)
    sb[(idx % D) * L + idx / D] = __ldg(g.b + idx);
}

// The state of one lane: its strip's R points and last column, the value
// received from the lane above at the step before, and its bottom cell.
// R is the pair's own strip height r, a compile-time constant: every row
// of the strip is a cell, so no row is predicated off.
template <int R, int D>
struct Lane {
  float a[R][D];
  float col[R];     // D[top + q, j - 1], then D[top + q, j]
  float diag;       // D[top - 1, j - 1]
  float bottom;     // D[top + R - 1, j]: the lane below reads it next step
  int k;

  __device__ __forceinline__ void init(const Pair& g, int lane) {
    k = lane;
    const int top = lane * R;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const bool in = top + q < g.la;
#pragma unroll
      for (int c = 0; c < D; ++c)
        a[q][c] = in ? __ldg(g.a + (top + q) * D + c) : 0.0f;
      col[q] = kInf;
    }
    diag = lane == 0 ? 0.0f : kInf;   // cell (0, 0): best = 0
    bottom = kInf;
  }

  // Step s: column j = s - k of the strip, `up` = D[top - 1, j].
  __device__ __forceinline__ void step(const Pair& g, int s, float up,
                                       const float* sb, int L) {
    const int j = s - k;
    float d = diag;
    diag = up;
    if (k > g.last || j < 0 || j >= g.lb) return;
    float bj[D];
#pragma unroll
    for (int c = 0; c < D; ++c) bj[c] = sb[c * L + j];
    // min(left, diag) of row q + 1 is taken before row q's cell replaces
    // its left value, so the cell is written in place (no register move)
    float u = up, m = min_nan(col[0], d);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float cost = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float t = a[q][c] - bj[c];
        cost = c == 0 ? t * t : cost + t * t;
      }
      float m_next = 0.0f;
      if (q + 1 < R) m_next = min_nan(col[q + 1], col[q]);
      u = cost + min_nan(u, m);
      col[q] = u;
      m = m_next;
    }
    bottom = u;
  }

  // D[la - 1, lb - 1], on the last lane after its last step
  __device__ __forceinline__ float result(const Pair& g) const {
    const int q_last = g.la - 1 - k * R;
    float v = kInf;
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (q == q_last) v = col[q];
    return v;
  }
};

template <int N>
struct Rows {
  static constexpr int value = N;
};

// f(Rows<r>()) for a pair's strip height r in [1, RMAX]: each height has
// its own code (uniform across the warp, chosen once a pair).
template <int RMAX, class F>
__device__ __forceinline__ void with_rows(int r, F&& f) {
  if constexpr (RMAX > 1) {
    if (r < RMAX) {
      with_rows<RMAX - 1>(r, f);
      return;
    }
  }
  f(Rows<RMAX>());
}

#ifndef DTW_HOST

template <int RMAX, int D>
__global__ void __launch_bounds__(MAX_WARPS * kWarp)
dtw_kernel(const float* __restrict__ stack_a,
           const float* __restrict__ stack_b, const int* __restrict__ len_a,
           const int* __restrict__ len_b, const int* __restrict__ ia,
           const int* __restrict__ ib, float* __restrict__ out, int P,
           int L) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (p >= P) return;   // a whole warp: nothing waits for it
  const Pair g = pair_at(stack_a, stack_b, len_a, len_b, ia, ib, p, L, D);
  float* sb = smem + warp * D * L;
  copy_b<D>(sb, g, L, lane, kWarp);
  with_rows<RMAX>(g.r, [&](auto rows) {
    Lane<decltype(rows)::value, D> ln;
    ln.init(g, lane);
    __syncwarp();
    for (int s = 0; s < g.steps; ++s) {
      float up = __shfl_up_sync(0xffffffffu, ln.bottom, 1);
      if (lane == 0) up = kInf;
      ln.step(g, s, up, sb, L);
    }
    if (lane == g.last) out[p] = sqrtf(ln.result(g));
  });
}

template <int R>
cudaError_t launch_r(const float* sa, const float* sb, const int* la,
                     const int* lb, const int* ia, const int* ib, float* out,
                     int P, int L, int D, int warps, cudaStream_t stream) {
  const int blocks = (P + warps - 1) / warps;
  const size_t smem = (size_t)warps * D * L * sizeof(float);
  switch (D) {
    case 1:
      dtw_kernel<R, 1><<<blocks, warps * kWarp, smem, stream>>>(
          sa, sb, la, lb, ia, ib, out, P, L);
      break;
    case 2:
      dtw_kernel<R, 2><<<blocks, warps * kWarp, smem, stream>>>(
          sa, sb, la, lb, ia, ib, out, P, L);
      break;
    default:
      dtw_kernel<R, 3><<<blocks, warps * kWarp, smem, stream>>>(
          sa, sb, la, lb, ia, ib, out, P, L);
  }
  return cudaGetLastError();
}

#else   // DTW_HOST

// One pair's terminal cell on the host: the warp's 32 lanes in turn each
// step, each lane's bottom cell published before any lane reads its
// neighbour's.
template <int RMAX, int D>
float host_pair(const Pair& g, int L) {
  std::vector<float> sb((size_t)D * L, 0.0f);
  copy_b<D>(sb.data(), g, L, 0, 1);
  float cell = 0.0f;
  with_rows<RMAX>(g.r, [&](auto rows) {
    Lane<decltype(rows)::value, D> lanes[kWarp];
    for (int k = 0; k < kWarp; ++k) lanes[k].init(g, k);
    float shfl[kWarp];
    for (int s = 0; s < g.steps; ++s) {
      for (int k = 0; k < kWarp; ++k) shfl[k] = lanes[k].bottom;
      for (int k = 0; k < kWarp; ++k)
        lanes[k].step(g, s, k == 0 ? kInf : shfl[k - 1], sb.data(), L);
    }
    cell = lanes[g.last].result(g);
  });
  return cell;
}

template <int R>
void host_r(const float* sa, const float* sb, const int* la, const int* lb,
            const int* ia, const int* ib, float* out, float* cells, int P,
            int L, int D) {
  for (int p = 0; p < P; ++p) {
    const Pair g = pair_at(sa, sb, la, lb, ia, ib, p, L, D);
    cells[p] = D == 1 ? host_pair<R, 1>(g, L)
             : D == 2 ? host_pair<R, 2>(g, L) : host_pair<R, 3>(g, L);
    out[p] = sqrtf(cells[p]);
  }
}

#endif  // DTW_HOST

}  // namespace

extern "C" {

int dtw_max_len() { return MAX_L; }
int dtw_max_dim() { return MAX_D; }
int dtw_max_warps() { return MAX_WARPS; }

#ifndef DTW_HOST

// P pairs; stacks [Na, L, D] and [Nb, L, D] float32; lengths int32 in
// [1, L]; pair indices int32; out [P] float32. R rows a lane at most, in
// {1, 2, 4, 8, 16} with 32 R >= L; `warps` pairs a block.
int dtw_launch(const void* stack_a, const void* stack_b, const void* len_a,
               const void* len_b, const void* ia, const void* ib, void* out,
               int P, int L, int D, int R, int warps, void* stream) {
  if (P == 0) return 0;
  if (L < 1 || L > MAX_L || D < 1 || D > MAX_D || warps < 1 ||
      warps > MAX_WARPS || kWarp * R < L)
    return (int)cudaErrorInvalidValue;
  const float *sa = (const float*)stack_a, *sb = (const float*)stack_b;
  const int *la = (const int*)len_a, *lb = (const int*)len_b;
  const int *pa = (const int*)ia, *pb = (const int*)ib;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1: return (int)launch_r<1>(sa, sb, la, lb, pa, pb, o, P, L, D, warps, st);
    case 2: return (int)launch_r<2>(sa, sb, la, lb, pa, pb, o, P, L, D, warps, st);
    case 4: return (int)launch_r<4>(sa, sb, la, lb, pa, pb, o, P, L, D, warps, st);
    case 8: return (int)launch_r<8>(sa, sb, la, lb, pa, pb, o, P, L, D, warps, st);
    case 16: return (int)launch_r<16>(sa, sb, la, lb, pa, pb, o, P, L, D, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dtw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#else   // DTW_HOST

// The same contract on the host, and each pair's terminal cell D[la-1,
// lb-1] in `cells` (out = its sqrtf); returns 0, or 1 for arguments the
// card's launch refuses.
int dtw_host(const float* stack_a, const float* stack_b, const int* len_a,
             const int* len_b, const int* ia, const int* ib, float* out,
             float* cells, int P, int L, int D, int R) {
  if (L < 1 || L > MAX_L || D < 1 || D > MAX_D || kWarp * R < L) return 1;
  const float *sa = stack_a, *sb = stack_b;
  switch (R) {
    case 1: host_r<1>(sa, sb, len_a, len_b, ia, ib, out, cells, P, L, D); break;
    case 2: host_r<2>(sa, sb, len_a, len_b, ia, ib, out, cells, P, L, D); break;
    case 4: host_r<4>(sa, sb, len_a, len_b, ia, ib, out, cells, P, L, D); break;
    case 8: host_r<8>(sa, sb, len_a, len_b, ia, ib, out, cells, P, L, D); break;
    case 16: host_r<16>(sa, sb, len_a, len_b, ia, ib, out, cells, P, L, D); break;
    default: return 1;
  }
  return 0;
}

#endif  // DTW_HOST

}  // extern "C"
