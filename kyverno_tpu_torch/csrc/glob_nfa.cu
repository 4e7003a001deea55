// K1 — glob NFA over the string dictionary: match[n, v] = glob(pattern n)
// accepts dictionary string v.
//
// Replaces kyverno_tpu/ops/glob.py::glob_match_matrix (with
// _epsilon_closure), which XLA ran as a [N, V, S+1] boolean lattice stepped
// under lax.scan.
//
// Bound on the H100: bytes. The inputs are V x 64 string bytes and a few
// hundred bytes of NFA tables; the output is N x V bytes. The work is at
// most 64 steps of a few 64-bit operations per (n, v), far below the
// card's integer rate, so the least time is the bytes over 3.35 TB/s.
//
// Design: shift-and. The S+1 <= 64 NFA states of one pattern are the bits
// of one uint64. A block serves one pattern n and 256 strings. Its 256
// threads first build the pattern's per-byte consume masks (bit i set when
// state i is '?' or its literal equals the byte) in shared memory, one
// byte value per thread, so the step loop reads a mask instead of
// comparing S states. One step is
//     s' = ((s & consume[c]) << 1) | (s & star);  s' |= (s' & star) << 1
// masked to S+1 bits, exactly the lattice's advance / stay / epsilon
// shift. The answer is bit nfa_len[n]. Each thread reads its string's
// bytes once, in order, from the packed dictionary (no unpack pass).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// A dictionary length word keeps flag bits above bit 7; lengths are <= 64.
constexpr uint32_t kLenMask = 0x7F;

__global__ void glob_nfa_kernel(const uint8_t* __restrict__ nfa_char,
                                const uint8_t* __restrict__ nfa_star,
                                const uint8_t* __restrict__ nfa_q,
                                const int32_t* __restrict__ nfa_len,
                                int S,
                                const uint8_t* __restrict__ str_bytes, int L,
                                const int32_t* __restrict__ str_len,
                                long long len_stride,
                                int V, uint8_t* __restrict__ out) {
  __shared__ unsigned long long consume[256];
  __shared__ unsigned long long star_sh;
  const int n = blockIdx.y;
  const unsigned long long full =
      (S + 1 == 64) ? ~0ull : ((1ull << (S + 1)) - 1ull);

  // consume mask for byte value c = threadIdx.x. The padded state S has
  // literal 0 and no '?', as in the lattice's padded tables.
  {
    const int c = threadIdx.x;
    unsigned long long m = 0;
    for (int i = 0; i <= S; ++i) {
      const int ch = (i < S) ? nfa_char[(long long)n * S + i] : 0;
      const bool q = (i < S) && nfa_q[(long long)n * S + i];
      if (q || ch == c) m |= 1ull << i;
    }
    consume[c] = m;
    if (threadIdx.x == 0) {
      unsigned long long st = 0;
      for (int i = 0; i < S; ++i)
        if (nfa_star[(long long)n * S + i]) st |= 1ull << i;
      star_sh = st;
    }
  }
  __syncthreads();

  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const unsigned long long star = star_sh;
  unsigned long long s = 1ull;
  s = (s | ((s & star) << 1)) & full;
  int len = (int)((uint32_t)str_len[(long long)v * len_stride] & kLenMask);
  if (len > L) len = L;
  const uint8_t* bytes = str_bytes + (long long)v * L;
  for (int j = 0; j < len; ++j) {
    const unsigned long long adv = ((s & consume[bytes[j]]) << 1) & full;
    unsigned long long nw = adv | (s & star);
    nw = (nw | ((nw & star) << 1)) & full;
    s = nw;
  }
  const int acc = nfa_len[n];
  out[(long long)n * V + v] = (uint8_t)((acc >= 0 && acc <= S) ? ((s >> acc) & 1ull) : 0);
}

}  // namespace

extern "C" int ktpu_glob_nfa(int64_t nfa_char, int64_t nfa_star, int64_t nfa_q,
                             int64_t nfa_len, int64_t N, int64_t S,
                             int64_t str_bytes, int64_t L, int64_t str_len,
                             int64_t len_stride, int64_t V,
                             int64_t out, int64_t stream) {
  dim3 grid((unsigned)((V + kThreads - 1) / kThreads), (unsigned)N);
  glob_nfa_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)nfa_char, (const uint8_t*)nfa_star,
      (const uint8_t*)nfa_q, (const int32_t*)nfa_len, (int)S,
      (const uint8_t*)str_bytes, (int)L, (const int32_t*)str_len,
      (long long)len_stride, (int)V, (uint8_t*)out);
  return (int)cudaGetLastError();
}
