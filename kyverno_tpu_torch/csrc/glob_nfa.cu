// K1 — glob NFA over the string dictionary: match[n, v] = glob(pattern n)
// accepts dictionary string v.
//
// Replaces the JAX package's ops/glob.py::glob_match_matrix (with
// _epsilon_closure), which XLA ran as a [N, V, S+1] boolean lattice stepped
// under lax.scan.
//
// Bound on the H100: bytes. The inputs are V x 64 string bytes, V length
// words and 2 KB of tables a pattern; the output is N x V bytes. The work
// is at most 64 steps of a few 64-bit operations per (n, v), far below the
// card's integer rate, so the least time is the bytes over 3.35 TB/s.
//
// Design: shift-and. The S+1 <= 64 NFA states of one pattern are the bits
// of one uint64. One step over byte c is
//     s' = ((s & consume[c]) << 1) | (s & star);  s' |= (s' & star) << 1
// masked to the S+1 live states (full), exactly the lattice's advance /
// stay / epsilon shift. The answer is bit acc = nfa_len[n].
//  - The tables depend only on the policy set, so ops/glob.py nfa_tables
//    builds them once with the plan: consume [N, 256] (bit i where state i
//    is '?' or its literal equals the byte), star, full and acc per
//    pattern. A block copies the tables of its up to kNP patterns into
//    shared memory (2 KB a pattern, 16-byte loads) and reads nothing else
//    of the patterns; grid.y = ceil(N / kNP) groups of patterns.
//  - Each thread takes one string and loads its 64 bytes into registers
//    before the step loop, as sixteen independent 4-byte loads (the string
//    area of a blob is 4-byte aligned, not 16), so no global load sits in
//    the dependent chain s -> consume[c] -> s'.
//  - The thread steps its block's patterns over those registers kChains
//    at a time, interleaved, so that the chains hide each other's latency.
//    A group short of kChains patterns pads with empty tables.
//  - Threads of a warp hold neighbouring strings, so out[n, v] is written
//    coalesced across v. A block takes 256, 128 or 64 strings: the largest
//    whose grid fills the card, so that few patterns and a small
//    dictionary still use every SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNP = 16;        // patterns a block
constexpr int kChains = 4;     // patterns stepped together by a thread
constexpr int kWords = 16;     // 64 string bytes as 4-byte words
// A dictionary length word keeps flag bits above bit 7; lengths are <= 64.
constexpr uint32_t kLenMask = 0x7F;

struct Tab {
  unsigned long long star, full;
  int acc;
};

__global__ void glob_nfa_kernel(const unsigned long long* __restrict__ consume,
                                const unsigned long long* __restrict__ star,
                                const unsigned long long* __restrict__ full,
                                const int32_t* __restrict__ acc, int N, int S,
                                const uint32_t* __restrict__ str_words,
                                const int32_t* __restrict__ str_len,
                                long long len_stride, int V,
                                uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned long long sh_consume[];
  __shared__ Tab sh_tab[kNP];
  const int n0 = blockIdx.y * kNP;
  const int np = min(kNP, N - n0);
  const int np_pad = (np + kChains - 1) / kChains * kChains;

  // ---- the block's tables: consume rows as 16-byte copies, padded rows 0
  {
    const uint4* src = (const uint4*)(consume + (long long)n0 * 256);
    uint4* dst = (uint4*)sh_consume;
    const int live = np * 128, total = np_pad * 128;   // 128 uint4 a row
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      dst[i] = i < live ? src[i] : make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < np_pad) {
      const int k = threadIdx.x;
      Tab t;
      t.star = k < np ? star[n0 + k] : 0ull;
      t.full = k < np ? full[n0 + k] : 0ull;
      t.acc = k < np ? acc[n0 + k] : -1;
      sh_tab[k] = t;
    }
  }
  __syncthreads();

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  int len = (int)((uint32_t)str_len[(long long)v * len_stride] & kLenMask);
  if (len > 4 * kWords) len = 4 * kWords;
  uint32_t w[kWords];
  const uint32_t* sw = str_words + (long long)v * kWords;
#pragma unroll
  for (int k = 0; k < kWords; ++k) w[k] = sw[k];

  for (int p0 = 0; p0 < np; p0 += kChains) {
    unsigned long long s[kChains], st[kChains], fl[kChains];
    const unsigned long long* cons[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const Tab t = sh_tab[p0 + k];
      st[k] = t.star;
      fl[k] = t.full;
      cons[k] = sh_consume + (p0 + k) * 256;
      s[k] = (1ull | (1ull & t.star) << 1) & t.full;
    }
#pragma unroll
    for (int j = 0; j < 4 * kWords; ++j) {
      if (j >= len) break;
      const uint32_t c = (w[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        unsigned long long nw = ((s[k] & cons[k][c]) << 1) | (s[k] & st[k]);
        s[k] = (nw | ((nw & st[k]) << 1)) & fl[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const int a = sh_tab[p0 + k].acc;
      if (p0 + k < np)
        out[(long long)(n0 + p0 + k) * V + v] =
            (uint8_t)((a >= 0 && a <= S) ? ((s[k] >> a) & 1ull) : 0ull);
    }
  }
}

int g_sms = 0;

}  // namespace

// consume [N, 256], star [N], full [N] (uint64), acc [N] int32: the plan's
// tables (ops/glob.py nfa_tables); str_bytes [V, 64] from a 4-byte aligned
// address; str_len [V] int32 at a stride of len_stride words; out [N, V].
extern "C" int ktpu_glob_nfa(int64_t consume, int64_t star, int64_t full,
                             int64_t acc, int64_t N, int64_t S,
                             int64_t str_bytes, int64_t str_len,
                             int64_t len_stride, int64_t V, int64_t out,
                             int64_t stream) {
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned groups = (unsigned)((N + kNP - 1) / kNP);
  int threads = 256;
  while (threads > 64 &&
         (long long)((V + threads - 1) / threads) * groups < g_sms)
    threads /= 2;
  const int np_pad = (int)((min((int64_t)kNP, N) + kChains - 1) / kChains) *
                     kChains;
  const size_t smem = (size_t)np_pad * 256 * sizeof(unsigned long long);
  const dim3 grid((unsigned)((V + threads - 1) / threads), groups);
  glob_nfa_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const unsigned long long*)consume, (const unsigned long long*)star,
      (const unsigned long long*)full, (const int32_t*)acc, (int)N, (int)S,
      (const uint32_t*)str_bytes, (const int32_t*)str_len,
      (long long)len_stride, (int)V, (uint8_t*)out);
  return (int)cudaGetLastError();
}
