// DTW distances between pairs of trajectory tracks, one thread block a pair.
//
// Replaces the XLA wavefront of the JAX package (ddiffpg_tpu/ops/dtw.py,
// dtw_pair :25 vmapped by dtw_batch_gather :67), a lax.scan over the 2L-1
// anti-diagonals of each pair's DP table whose every step reads and writes
// the [P, L] diagonals in device memory. Here a block keeps both tracks
// (at most 2 x 512 x 3 floats) and three rolling diagonals of its table
// (3 x 512 floats) in shared memory, so device memory sees each track
// once and each distance once. The work is then ~8 flops a cell over
// sum(la * lb) cells; what bounds it on an H100 is the serial chain of
// diagonals, one __syncthreads each, not bytes or flops.
//
// Thread i of the block owns row i of the table: on diagonal d it computes
// cell (i, d - i) from row i-1 and row i of diagonal d-1 and row i-1 of
// diagonal d-2. The three diagonals rotate, so one barrier a diagonal
// suffices: the buffer written on diagonal d+1 was last read on d.
// Arithmetic follows the plain version (dtw_wavefront in ops/dtw.py) op by
// op: the cost summed over the point's coordinates in index order, then
// cost + min(min(up, left), diag), 3.4e38 off the table, sqrt at the end.
// Built with -fmad=false, so no a*b+c is contracted and both round alike.
//
// Plain C interface for ctypes; the launch returns the CUDA error code.

#include <cuda_runtime.h>

#define MAX_L 512
#define MAX_D 3

namespace {

constexpr float kInf = 3.4e38f;

__global__ void __launch_bounds__(MAX_L)
dtw_kernel(const float* __restrict__ stack_a, const float* __restrict__ stack_b,
           const int* __restrict__ len_a, const int* __restrict__ len_b,
           const int* __restrict__ ia, const int* __restrict__ ib,
           float* __restrict__ out, int L, int D) {
  __shared__ float ta[MAX_L * MAX_D];
  __shared__ float tb[MAX_L * MAX_D];
  __shared__ float diag[3][MAX_L];

  const int p = blockIdx.x;
  const int i = threadIdx.x;
  const int ra = ia[p], rb = ib[p];
  const int n = len_a[ra], m = len_b[rb];
  const float* a = stack_a + (size_t)ra * L * D;
  const float* b = stack_b + (size_t)rb * L * D;
  for (int k = i; k < n * D; k += blockDim.x) ta[k] = a[k];
  for (int k = i; k < m * D; k += blockDim.x) tb[k] = b[k];
  for (int k = i; k < MAX_L; k += blockDim.x) {
    diag[0][k] = kInf;
    diag[1][k] = kInf;
    diag[2][k] = kInf;
  }
  __syncthreads();

  const int last = n + m - 2;
  for (int d = 0; d <= last; ++d) {
    const float* dm1 = diag[(d + 2) % 3];   // diagonal d-1
    const float* dm2 = diag[(d + 1) % 3];   // diagonal d-2
    float* cur = diag[d % 3];
    const int j = d - i;
    float val = kInf;
    if (i < n && j >= 0 && j < m) {
      float cost = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float t = ta[i * D + k] - tb[j * D + k];
        cost = k == 0 ? t * t : cost + t * t;
      }
      const float up = i > 0 ? dm1[i - 1] : kInf;
      const float left = dm1[i];
      const float dg = i > 0 ? dm2[i - 1] : kInf;
      float best = fminf(fminf(up, left), dg);
      if (i == 0 && j == 0) best = 0.0f;
      val = cost + best;
    }
    cur[i] = val;
    if (d == last && i == n - 1) out[p] = sqrtf(val);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int dtw_max_len() { return MAX_L; }
int dtw_max_dim() { return MAX_D; }

// P pairs; stacks [Na, L, D] and [Nb, L, D] float32; lengths int32 in
// [1, L]; pair indices int32; out [P] float32.
int dtw_launch(const void* stack_a, const void* stack_b, const void* len_a,
               const void* len_b, const void* ia, const void* ib, void* out,
               int P, int L, int D, int threads, void* stream) {
  if (P == 0) return 0;
  if (L < 1 || L > MAX_L || D < 1 || D > MAX_D || threads < L ||
      threads > MAX_L || threads % 32)
    return (int)cudaErrorInvalidValue;
  dtw_kernel<<<P, threads, 0, (cudaStream_t)stream>>>(
      (const float*)stack_a, (const float*)stack_b, (const int*)len_a,
      (const int*)len_b, (const int*)ia, (const int*)ib, (float*)out, L, D);
  return (int)cudaGetLastError();
}

const char* dtw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
