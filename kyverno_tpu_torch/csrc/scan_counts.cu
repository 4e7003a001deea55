// K5 — background-scan counts: per-rule FAIL and PASS counts over the rows
// that hold no HOST cell, and host_rows [B].
//
// Replaces the reduction tail of kyverno_tpu/ops/eval.py::build_scan_fn_blob
// (eval.py:966-975), which XLA fused after the verdict program so the scan
// read back bytes instead of the [B, R] matrix.
//
// Bound on the H100: bytes. The [B, R] int8 matrix is read (twice, once
// per launch; the bound counts it once) and B + 8R bytes are written.
//
// Design: two launches. rows_kernel: one warp per row, lanes striding over
// the row's R bytes, a warp vote for "any HOST". counts_kernel: a block
// owns 256 rules (one per thread, so a warp reads 32 neighbouring bytes of
// a row) and a tile of rows; each thread counts its rule over the tile in
// registers, skipping HOST rows, then adds its two partial counts to the
// [R] outputs with one atomicAdd each. The counts are integers, so the
// order of the atomics cannot change them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 256;
constexpr int kHost = 5, kPass = 1, kFail = 2;

__global__ void rows_kernel(const int8_t* __restrict__ v, int B, int R,
                            uint8_t* __restrict__ host_rows) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B) return;
  const int8_t* row = v + (long long)warp * R;
  bool host = false;
  for (int r = lane; r < R; r += 32) host = host || row[r] == kHost;
  host = __any_sync(0xFFFFFFFFu, host);
  if (lane == 0) host_rows[warp] = host ? 1 : 0;
}

__global__ void counts_kernel(const int8_t* __restrict__ v, int B, int R,
                              const uint8_t* __restrict__ host_rows,
                              int* __restrict__ fails,
                              int* __restrict__ passes) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kRowsPerTile;
  const int b1 = min(b0 + kRowsPerTile, B);
  int nf = 0, np = 0;
  for (int b = b0; b < b1; ++b) {
    if (host_rows[b]) continue;
    const int8_t x = v[(long long)b * R + r];
    nf += x == kFail;
    np += x == kPass;
  }
  if (nf) atomicAdd(fails + r, nf);
  if (np) atomicAdd(passes + r, np);
}

}  // namespace

extern "C" int ktpu_scan_counts(int64_t v, int64_t B, int64_t R,
                                int64_t fails, int64_t passes,
                                int64_t host_rows, int64_t stream) {
  // fails and passes arrive zeroed: the wrapper allocates them so.
  cudaStream_t st = (cudaStream_t)stream;
  const long long threads = B * 32;
  rows_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                st>>>((const int8_t*)v, (int)B, (int)R, (uint8_t*)host_rows);
  if (R > 0) {
    dim3 grid((unsigned)((R + kThreads - 1) / kThreads),
              (unsigned)((B + kRowsPerTile - 1) / kRowsPerTile));
    counts_kernel<<<grid, kThreads, 0, st>>>(
        (const int8_t*)v, (int)B, (int)R, (const uint8_t*)host_rows,
        (int*)fails, (int*)passes);
  }
  return (int)cudaGetLastError();
}
