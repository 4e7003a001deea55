// K7's reduction — per-rule FAIL and PASS counts over every row of a
// verdict matrix: fails[r] = #{b : v[b, r] == FAIL}, passes[r] =
// #{b : v[b, r] == PASS}. HOST cells count as neither (the scan adds the
// oracle's verdicts for them on the host), and padded rows read
// NOT_APPLICABLE, so they count as neither too.
//
// Replaces the count tail of the JAX package's parallel/mesh.py::sharded_eval_fn
// (mesh.py:197-198) and of shard_eval_fns' per-shard programs
// (mesh.py:247-248): jnp.sum(verdict == V_FAIL, axis=0) and the same for
// V_PASS, which XLA fused behind the verdict program of each data shard
// and all-reduced over the mesh. Unlike K5 (scan_counts.cu) it keeps the
// cells of rows that hold a HOST cell.
//
// Bound on the H100: bytes. The matrix is read once (B R bytes) and 8 R
// bytes are written; per byte the work is two compares and two adds.
//
// Design: a grid over (column tile, row range).
//  - A thread owns one column and walks its block's row range, so that the
//    32 threads of a warp read 32 neighbouring bytes of a row. The matrix
//    may be a column slice of a wider one: rows are ``ld`` bytes apart.
//  - Both counts stay in registers; each thread adds them to the outputs
//    with one integer atomicAdd a column a block, exact in any order.
//  - grid.y cuts the rows into ranges, enough of them that the grid holds
//    about four blocks an SM. The C entry zeroes the two counts, one
//    [2, R] buffer, with one memset before the launch.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFail = 2;
constexpr int kPass = 1;

__global__ void rule_counts_kernel(const int8_t* __restrict__ v, int B, int R,
                                   long long ld, int rows,
                                   int* __restrict__ fails,
                                   int* __restrict__ passes) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * rows;
  const int b1 = min(B, b0 + rows);
  const int8_t* p = v + (long long)b0 * ld + r;
  int nf = 0, np = 0;
#pragma unroll 8
  for (int b = b0; b < b1; ++b, p += ld) {
    const int x = *p;
    nf += x == kFail;
    np += x == kPass;
  }
  if (nf) atomicAdd(fails + r, nf);
  if (np) atomicAdd(passes + r, np);
}

int g_sms = 0;

}  // namespace

// v [B, R] int8 with rows ld bytes apart (ld >= R); counts [2, R] int32
// (fails, then passes). B > 0, R > 0.
extern "C" int ktpu_rule_counts(int64_t v, int64_t B, int64_t R, int64_t ld,
                                int64_t counts, int64_t stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaMemsetAsync((void*)counts, 0, (size_t)R * 2 * 4, st);
  if (err != cudaSuccess) return (int)err;
  const long long b = B, cols = (R + kThreads - 1) / kThreads;
  // about four blocks an SM, and at least 32 rows a block
  const long long ranges =
      std::max(1LL, std::min((b + 31) / 32, (4LL * g_sms + cols - 1) / cols));
  const long long rows = (b + ranges - 1) / ranges;
  const dim3 grid((unsigned)cols, (unsigned)((b + rows - 1) / rows));
  rule_counts_kernel<<<grid, kThreads, 0, st>>>(
      (const int8_t*)v, (int)B, (int)R, (long long)ld, (int)rows,
      (int*)counts, (int*)counts + R);
  return (int)cudaGetLastError();
}
