// Exact maximum clique of each pair's restricted consistency graph.
//
// Replaces the lax.while_loop of quatro_tpu/solver/clique.py::exact_max_clique_bb
// (the loop at :382, vmapped over the pairs): its Carraghan-Pardalos DFS
// over the cap highest-scored vertices (PMC_EXACT, reference
// src/graph.cc:106-127), for B pairs in one launch. It is no Pallas kernel:
// the JAX package runs this search as one device program, and the port's
// counterpart is this kernel rather than a host loop.
//
// Per pair, from the restriction sub (cap, cap) bytes 0/1, its valid
// vertices vvalid (cap) and the incumbent best0 (cap):
//   frame stack (P, C) with P[0] = vvalid, C[0] = {}, sp = 1, steps = 0,
//   best = best0, |best| = popcount(best0); while sp > 0 and steps <
//   max_steps: pop (P, C) = frame sp - 1; if |C| > |best|, best = C; if
//   |C| + |P| > |best| and P is not empty, v = the lowest vertex of P, the
//   exclude frame (P \ {v}, C) replaces the popped slot and the include
//   frame (P & N(v), C | {v}) goes on top (sp + 1), else sp - 1; steps + 1.
// Outputs best & vvalid, completed = (sp == 0) and steps, bit for bit those
// of the JAX loop and of quatro_tpu_torch/ops/kernels.py::exact_clique_search_plain
// (boolean logic and integer counts only).
//
// Bound on the card: the work is one dependent walk per pair. Its bytes
// (the B cap^2 restriction read once, a few bytes per vertex written) and
// its word operations are far below a microsecond at path B's shape; what
// bounds it is the latency of each step's chain (load the frame, count,
// pick v, store two frames), which no bound in bytes or operations sees.
// Design: one warp per pair; the bitsets are 64-bit words, lane l owning
// words l, l + 32, ... of every set, so each lane reads and writes only its
// own words and the step needs no barrier. |C| and |P| are __popcll summed
// by a shuffle reduction; the first candidate is the lowest lane whose word
// is non-zero (__ballot_sync, __ffs) and that word's lowest bit (__ffsll).
// The adjacency rows become bitsets once, at the start (two ballots per
// word). The frame stack (cap + 2 frames of two bitsets), the adjacency
// bitsets and the best set live in a global scratch that the wrapper
// allocates; keeping them in shared memory is later work.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kCliqueWarps = 4;            // pairs per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Word w of the bitset of bytes row[0 .. cap - 1] (bit i set where row[64 w
// + i] != 0), the same in every lane.
__device__ __forceinline__ unsigned long long ballot_word(const unsigned char* row, int cap,
                                                          int w, int lane) {
  const int j0 = 64 * w + lane, j1 = j0 + 32;
  const unsigned lo = __ballot_sync(kFull, j0 < cap && row[j0] != 0);
  const unsigned hi = __ballot_sync(kFull, j1 < cap && row[j1] != 0);
  return ((unsigned long long)hi << 32) | lo;
}

__global__ void __launch_bounds__(32 * kCliqueWarps)
exact_clique_kernel(const unsigned char* __restrict__ sub,
                    const unsigned char* __restrict__ vvalid,
                    const unsigned char* __restrict__ best0, int batch, int cap,
                    int max_steps, unsigned long long* __restrict__ scratch,
                    unsigned char* __restrict__ best_out,
                    unsigned char* __restrict__ completed, int* __restrict__ steps_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kCliqueWarps + (threadIdx.x >> 5);
  if (b >= batch) return;                  // the whole warp leaves
  const int words = (cap + 63) / 64;
  const int depth = cap + 2;
  // this pair's scratch: adjacency rows, P frames, C frames, best set
  unsigned long long* adj =
      scratch + (size_t)b * words * (cap + 2 * depth + 1);
  unsigned long long* pst = adj + (size_t)cap * words;
  unsigned long long* cst = pst + (size_t)depth * words;
  unsigned long long* best = cst + (size_t)depth * words;
  sub += (size_t)b * cap * cap;
  vvalid += (size_t)b * cap;
  best0 += (size_t)b * cap;

  for (int v = 0; v < cap; ++v)
    for (int w = 0; w < words; ++w) {
      const unsigned long long x = ballot_word(sub + (size_t)v * cap, cap, w, lane);
      if ((w & 31) == lane) adj[(size_t)v * words + w] = x;
    }
  int best_size = 0;                       // the same in every lane
  for (int w = 0; w < words; ++w) {
    const unsigned long long p0 = ballot_word(vvalid, cap, w, lane);
    const unsigned long long b0 = ballot_word(best0, cap, w, lane);
    if ((w & 31) == lane) {
      pst[w] = p0;
      cst[w] = 0ull;
      best[w] = b0;
    }
    best_size += __popcll(b0);
  }

  // sp, steps, best_size, csz, psz and v are warp-uniform: every branch
  // below is taken by all 32 lanes
  int sp = 1, steps = 0;
  while (sp > 0 && steps < max_steps) {
    const int sp1 = sp - 1;
    unsigned long long* p = pst + (size_t)sp1 * words;
    const unsigned long long* c = cst + (size_t)sp1 * words;
    int csz = 0, psz = 0, v = -1;
    for (int g = 0; g < words; g += 32) {
      const int w = g + lane;
      unsigned long long pw = 0ull, cw = 0ull;
      if (w < words) {
        pw = p[w];
        cw = c[w];
      }
      csz += __popcll(cw);
      psz += __popcll(pw);
      const unsigned nonzero = __ballot_sync(kFull, pw != 0ull);
      if (v < 0 && nonzero != 0u) {
        const int src = __ffs(nonzero) - 1;
        const unsigned long long first = __shfl_sync(kFull, pw, src);
        v = 64 * (g + src) + __ffsll((long long)first) - 1;
      }
    }
    csz = warp_sum(csz);
    psz = warp_sum(psz);
    if (csz > best_size) {
      best_size = csz;
      for (int w = lane; w < words; w += 32) best[w] = c[w];
    }
    if (csz + psz > best_size && psz > 0) {
      // exclude v in the popped slot, include v on top
      const unsigned long long* row = adj + (size_t)v * words;
      unsigned long long* p_in = p + words;
      unsigned long long* c_in = cst + (size_t)(sp1 + 1) * words;
      for (int w = lane; w < words; w += 32) {
        const unsigned long long vm = w == (v >> 6) ? 1ull << (v & 63) : 0ull;
        const unsigned long long pw = p[w];
        p_in[w] = pw & row[w];
        c_in[w] = c[w] | vm;
        p[w] = pw & ~vm;
      }
      sp = sp1 + 2;
    } else {
      sp = sp1;
    }
    ++steps;
  }

  __syncwarp();                            // best's words come from every lane
  for (int i = lane; i < cap; i += 32)
    best_out[(size_t)b * cap + i] =
        (unsigned char)(((best[i >> 6] >> (i & 63)) & 1ull) != 0ull && vvalid[i] != 0);
  if (lane == 0) {
    completed[b] = (unsigned char)(sp == 0);
    steps_out[b] = steps;
  }
}

}  // namespace quatro

// sub (B, cap, cap), vvalid (B, cap), best0 (B, cap) bytes 0/1; scratch
// B * words * (3 cap + 5) uint64 with words = ceil(cap / 64); best (B, cap)
// bytes, completed (B,) bytes, steps (B,) int32. B > 0, cap >= 0.
extern "C" int quatro_exact_clique(const unsigned char* sub, const unsigned char* vvalid,
                                   const unsigned char* best0, int batch, int cap,
                                   int max_steps, unsigned long long* scratch,
                                   unsigned char* best, unsigned char* completed,
                                   int* steps, cudaStream_t stream) {
  if (batch <= 0 || cap < 0) return (int)cudaErrorInvalidValue;
  const int grid = (batch + quatro::kCliqueWarps - 1) / quatro::kCliqueWarps;
  quatro::exact_clique_kernel<<<grid, 32 * quatro::kCliqueWarps, 0, stream>>>(
      sub, vvalid, best0, batch, cap, max_steps, scratch, best, completed, steps);
  return (int)cudaGetLastError();
}
