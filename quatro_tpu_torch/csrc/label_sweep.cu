// One min-label sweep of the range-image labelling, for a batch of images.
//
// The counterpart of the sweep of quatro_tpu/preprocessing/projection.py:203
// (label_components: XLA fuses each roll-doubling step's rolls, wheres and
// mins into loop fusions inside the lax.while_loop at :269; no Pallas
// kernel there), bit for bit quatro_tpu_torch/ops/labels.py::
// label_sweep_plain, the same doubling in torch operations.
//
// labels (B, R, C) int32, edges (B, R, C) bool, out (B, R, C) int32; the
// sweep's offset d = (dr, dc), its doubling steps and npix. With
// K = 2^(steps - 1) and m(i) the number of consecutive holding edges
// e[i], e[i + d], e[i + 2d], ... (positions wrap on both axes, as the rolls
// do; infinite when the whole cycle holds):
//   out[i] = min(labels[i + k d] for k = 0 .. min(K, m(i))),
// and also min'd with npix where steps >= 2 and m(i) <= K - 2 (the
// doubling's where(gate, cand, npix) on a broken gate somewhere in its
// tree; the labelling's labels never exceed npix, so it changes nothing
// there, but it keeps the kernel the plain version's function on any
// input).
//
// Bound on the card: bytes. A sweep reads the labels and the edges once
// and writes the labels: 9 bytes a pixel, 132.7 MB at path P's B = 64 (128
// images of 64 x 1800), 0.040 ms at 3.35 TB/s.
// Design: two kernels, by the offset.
// - dr == 0: the chain stays in its row, and runs round it on a wall (K
//   covers the row's cycle: 1800 steps a pixel). One block per (image,
//   row), the row's labels and edges in shared memory, and the doubling
//   itself there (steps - 1 passes over the row, two buffers, one barrier
//   a pass).
// - dr != 0: one thread per pixel walking the chain from it, at most
//   min(K, the cycle's length) steps; the row boundary's edges are 0 in
//   the labelling, so a walk
//   stops within R steps (<= 4 for 4CrossNeighbor's diagonal sweeps, <= 32
//   for its composed (+-2, 0) ones). Neighbouring threads walk
//   neighbouring columns, so each step's loads are coalesced.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kSweepThreads = 256;
constexpr int kRowSmemLimit = 227 * 1024;

__host__ __device__ __forceinline__ int wrap_mod(long long v, int n) {
  long long r = v % n;
  return (int)(r < 0 ? r + n : r);
}

// The doubling of one row in shared memory: level 0, then steps - 1
// passes, each reading the other buffer.
__global__ void __launch_bounds__(kSweepThreads)
label_sweep_row_kernel(const int* __restrict__ labels,
                       const unsigned char* __restrict__ edges, int cols, int dc,
                       int steps, int npix, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* best_a = smem;
  int* best_b = smem + cols;
  unsigned char* gate_a = reinterpret_cast<unsigned char*>(smem + 2 * cols);
  unsigned char* gate_b = gate_a + cols;
  const size_t base = (size_t)blockIdx.x * cols;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    best_b[c] = labels[base + c];
    gate_a[c] = edges[base + c];
  }
  __syncthreads();
  const int sh0 = wrap_mod(dc, cols);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    int j = c + sh0;
    if (j >= cols) j -= cols;
    const int l = best_b[c];
    best_a[c] = gate_a[c] ? min(l, best_b[j]) : l;
  }
  __syncthreads();
  int* cur = best_a;
  int* nxt = best_b;
  unsigned char* g = gate_a;
  unsigned char* gn = gate_b;
  long long s = 1;
  for (int it = 0; it < steps - 1; ++it) {
    const int sh = wrap_mod(s * dc, cols);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      int j = c + sh;
      if (j >= cols) j -= cols;
      const bool gc = g[c] != 0;
      nxt[c] = min(cur[c], gc ? cur[j] : npix);
      gn[c] = gc && g[j];
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
    unsigned char* u = g;
    g = gn;
    gn = u;
    s *= 2;
  }
  for (int c = threadIdx.x; c < cols; c += blockDim.x) out[base + c] = cur[c];
}

// The chain walk from each pixel, at most ``limit`` = min(K, the cycle's
// length) steps: a walk that goes round the whole cycle has seen every
// label it can reach, and its chain never breaks.
__global__ void __launch_bounds__(kSweepThreads)
label_sweep_walk_kernel(const int* __restrict__ labels,
                        const unsigned char* __restrict__ edges, long long total,
                        int rows, int cols, int dr, int dc, int steps, long long limit,
                        int npix, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int img_px = rows * cols;
  const long long img = i / img_px;
  const int p = (int)(i - img * img_px);
  const int* lab = labels + img * img_px;
  const unsigned char* e = edges + img * img_px;
  int r = p / cols;
  int c = p - r * cols;
  const int sr = wrap_mod(dr, rows);
  const int sc = wrap_mod(dc, cols);
  const long long reach = 1LL << (steps - 1);
  int v = lab[p];
  long long m = 0;
  while (m < limit && e[r * cols + c]) {
    r += sr;
    if (r >= rows) r -= rows;
    c += sc;
    if (c >= cols) c -= cols;
    v = min(v, lab[r * cols + c]);
    ++m;
  }
  // a chain that broke after m edges: the doubling's broken gates
  if (steps >= 2 && m < limit && m <= reach - 2) v = min(v, npix);
  out[i] = v;
}

__host__ long long gcd_ll(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace quatro

extern "C" int quatro_label_sweep(const int* labels, const unsigned char* edges, int bsz,
                                  int rows, int cols, int dr, int dc, int steps, int npix,
                                  int* out, cudaStream_t stream) {
  using namespace quatro;
  if (bsz <= 0 || rows <= 0 || cols <= 0) return 0;
  if (steps < 1 || steps > 40) return (int)cudaErrorInvalidValue;
  if (dr == 0) {
    const size_t smem = (size_t)cols * (2 * sizeof(int) + 2);
    if (smem > (size_t)kRowSmemLimit) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          label_sweep_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    label_sweep_row_kernel<<<bsz * rows, kSweepThreads, smem, stream>>>(
        labels, edges, cols, dc, steps, npix, out);
  } else {
    // the cycle of positions i, i + d, ... on the (rows, cols) torus
    const long long pr = rows / gcd_ll(wrap_mod(dr, rows), rows);
    const long long pc = cols / gcd_ll(wrap_mod(dc, cols), cols);
    const long long period = pr / gcd_ll(pr, pc) * pc;
    const long long reach = 1LL << (steps - 1);
    const long long total = (long long)bsz * rows * cols;
    const long long blocks = (total + kSweepThreads - 1) / kSweepThreads;
    label_sweep_walk_kernel<<<(unsigned)blocks, kSweepThreads, 0, stream>>>(
        labels, edges, total, rows, cols, dr, dc, steps, reach < period ? reach : period,
        npix, out);
  }
  return (int)cudaGetLastError();
}
