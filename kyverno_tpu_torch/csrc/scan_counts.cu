// K5 — background-scan counts: per-rule FAIL and PASS counts over the rows
// that hold no HOST cell, and host_rows [B], from the bit masks that the
// scan form of eval_rules writes (eval_rules.cu, rules_kernel<true>).
//
// Replaces the reduction tail of the JAX package's ops/eval.py::build_scan_fn_blob
// (eval.py:966-975), which XLA fused after the verdict program so that the
// [B, R] matrix never left the chip. The port keeps it on chip the same
// way: eval_rules' scan form turns each rule's verdict planes into FAIL,
// PASS and HOST masks of 32 resources a word, so this kernel reads
// 2 G R + n_tiles G words (G = ceil(B / 32)) instead of B R bytes.
//
// Bound on the H100: bytes. The masks are read once and 8 R + B bytes
// are written; per word the work is two ANDs and two popcounts.
//
// Design: one launch. host[g] is the OR over rule tiles of host_m[t, g];
// fails[r] = sum over g of popc(fail_m[g, r] & ~host[g]), and the same
// for pass_m; host_rows[b] is bit b % 32 of host[b / 32].
//  - A thread per rule, so that a warp reads 32 neighbouring words of a
//    mask row. grid.y splits the words g into chunks, enough of them that
//    the grid fills the card twice over at 10k and 100k resources; each
//    block first ORs its chunk's host words into shared memory.
//  - Partial counts are added to the outputs with integer atomicAdd, exact
//    in any order. The C entry zeroes the two counts, one [2, R] buffer,
//    with one memset before the launch (the wrapper would need two fills).
//  - The blocks of the first rule column write host_rows for their chunk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxChunk = 4096;

__global__ void counts_kernel(const uint32_t* __restrict__ fail_m,
                              const uint32_t* __restrict__ pass_m,
                              const uint32_t* __restrict__ host_m, int T,
                              int G, int R, int B, int chunk,
                              int* __restrict__ fails,
                              int* __restrict__ passes,
                              uint8_t* __restrict__ host_rows) {
  extern __shared__ uint32_t host[];
  const int g0 = blockIdx.y * chunk;
  const int ng = min(chunk, G - g0);
  for (int i = threadIdx.x; i < ng; i += blockDim.x) {
    uint32_t h = 0;
    for (int t = 0; t < T; ++t) h |= host_m[(long long)t * G + g0 + i];
    host[i] = h;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    const int b1 = min((g0 + ng) * 32, B);
    for (int b = g0 * 32 + threadIdx.x; b < b1; b += blockDim.x)
      host_rows[b] = (uint8_t)((host[(b >> 5) - g0] >> (b & 31)) & 1u);
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  int nf = 0, np = 0;
  for (int i = 0; i < ng; ++i) {
    const long long at = (long long)(g0 + i) * R + r;
    const uint32_t keep = ~host[i];
    nf += __popc(fail_m[at] & keep);
    np += __popc(pass_m[at] & keep);
  }
  if (nf) atomicAdd(fails + r, nf);
  if (np) atomicAdd(passes + r, np);
}

int g_sms = 0;

}  // namespace

// fail_m, pass_m [G, R] and host_m [T, G] uint32; counts [2, R] int32
// (fails, then passes); host_rows [B] bool. G = ceil(B / 32) > 0.
extern "C" int ktpu_scan_counts(int64_t fail_m, int64_t pass_m, int64_t host_m,
                                int64_t T, int64_t G, int64_t R, int64_t B,
                                int64_t counts, int64_t host_rows,
                                int64_t stream) {
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
  const long long cols = R > 0 ? (R + kThreads - 1) / kThreads : 1;
  // at most kMaxChunk words a block, so that its host words fit the
  // default 48 KB of shared memory
  const long long rows_target = max((2LL * g_sms + cols - 1) / cols,
                                    (G + kMaxChunk - 1) / kMaxChunk);
  const long long chunk = (G + rows_target - 1) / rows_target;
  const dim3 grid((unsigned)cols, (unsigned)((G + chunk - 1) / chunk));
  counts_kernel<<<grid, kThreads, chunk * sizeof(uint32_t), st>>>(
      (const uint32_t*)fail_m, (const uint32_t*)pass_m,
      (const uint32_t*)host_m, (int)T, (int)G, (int)R, (int)B, (int)chunk,
      (int*)counts, (int*)counts + R, (uint8_t*)host_rows);
  return (int)cudaGetLastError();
}
