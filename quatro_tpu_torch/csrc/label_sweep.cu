// The range-image labelling, every sweep of every round, for a batch of
// images in one launch.
//
// The counterpart of label_components' lax.while_loop at
// quatro_tpu/preprocessing/projection.py:269, its propagate (:246) and its
// sweep (:203) (XLA fuses each roll-doubling step's rolls, wheres and mins
// into loop fusions; no Pallas kernel there), bit for bit
// quatro_tpu_torch/ops/labels.py::label_sweeps_plain: a while_chunks
// device loop of rounds, each every sweep of the schedule in order
// (label_sweep_plain, the roll-doubling in torch operations), then
// where(valid, out, npix).
//
// labels (B, R, C) int32 (the initial labels), valid (B, R, C) bool and
// up to 8 edge masks (B, R, C) bool, one a sweep -> out (B, R, C) int32
// and rounds (B,) int32. A sweep has an offset d = (dr, dc), its doubling
// steps and npix. With K = 2^(steps - 1) and m(i) the number of
// consecutive holding edges e[i], e[i + d], e[i + 2d], ... (positions wrap
// on both axes, as the rolls do; infinite when the whole cycle holds):
//   out[i] = min(labels[i + k d] for k = 0 .. min(K, m(i))),
// and also min'd with npix where steps >= 2 and m(i) <= K - 2 (the
// doubling's where(gate, cand, npix) on a broken gate somewhere in its
// tree; the labelling's labels never exceed npix, so it changes nothing
// there, but it keeps the kernel the plain version's function on any
// input). Each sweep reads the previous sweep's whole output (Jacobi).
//
// The per-image loop: each image runs rounds until a round changes none
// of its labels (compared with the round's input), or max_iters rounds,
// as the JAX package's cond / body count them; rounds[b] is that count.
// The plain version runs the whole batch to its slowest image, but a
// round is a fixed point once an image's round has changed nothing, so an
// image that stops at its own exit ends with the batched loop's bits.
//
// Bound on the card: bytes. The labelling reads valid and the edge masks
// once and writes the labels once: 13 bytes a pixel under 8 masks (9
// under 4), 192 MB at path P's B = 64 (128 images of 64 x 1800), 0.057 ms
// at 3.35 TB/s.
// Design: one thread-block cluster per image, the image held in the
// cluster's distributed shared memory for the whole labelling, so global
// memory is read once and written once.
// - Layout: a CTA of the cluster owns ceil(R / cluster) rows: their labels
//   in two int32 buffers (a sweep reads one and writes the other), one
//   byte a pixel of edge bits (bit s: sweep s's mask) and one of valid: 10
//   bytes a pixel. An HDL-64E image (64 x 1800) takes 72 KB a CTA in a
//   cluster of 16, 144 KB in one of 8.
// - dr == 0 sweeps whose K covers the row's cycles (every labelling sweep
//   of the presets) stay in a row (the chain runs round it on a wall), in
//   the CTA's own shared memory: the min to the next break as a segmented
//   suffix scan along each cycle (row_scan), one warp a (row, cycle), a
//   chunk a lane, the chunks composed by shuffles, the wrap closed by the
//   value at the cycle's start.
// - Every other sweep walks each pixel's chain, at most min(K, the
//   cycle's length) steps; the row boundary's edges are 0 in the
//   labelling, so a walk with dr != 0 stops within R steps (<= 4 for
//   4CrossNeighbor's diagonal sweeps, <= 32 for its composed (+-2, 0)
//   ones). A step on another CTA's rows reads its labels and edge bits
//   through DSMEM (map_shared_rank); a cluster.sync() ends every sweep.
// - The change flag: a pixel changed where a sweep lowered a valid
//   pixel's label (the sweeps only lower labels, so the round's output
//   differs from its input exactly there) or where an invalid pixel's
//   label was not npix at the round's start. Each CTA ORs its threads'
//   flags, writes its word, and after a cluster.sync every CTA ORs all
//   the cluster's words (integer reads; alternate words in alternate
//   rounds), so every CTA takes the same exit.
// - Layout: CTAs of 1024 threads in clusters of 16 (non-portable) or 8,
//   whichever the resident clusters (cudaOccupancyMaxActiveClusters) and
//   the batch finish in the fewest waves per CTA of a cluster;
//   quatro_label_layout reports the choice.
// - The global route (label_sweeps_kernel<true>): an image of 1-11 rows
//   can be wider than the shared memory of a cluster of at most that many
//   CTAs holds (1 x 131071 takes 1.3 MB). There the same code keeps each
//   CTA's two label buffers, edge bits and valid bytes in a slab of a
//   global workspace that the wrapper allocates, and a walk reads another
//   CTA's slab through L2 (ld.global.cg) after the cluster.sync() that
//   ends each sweep; the flag still goes through DSMEM. No sensor has so
//   few rows, so this route is for coverage, not speed.
#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace quatro {

constexpr int kThreads = 1024;                  // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSweeps = 8;
constexpr int kMaxCluster = 16;
constexpr int kPixelBytes = 10;                 // 2 x int32 + 2 bytes
constexpr int kDynSmemLimit = 226 * 1024;       // leaves 1 KB of static

struct Sweeps {
  const unsigned char* edges[kMaxSweeps];
  long long limit[kMaxSweeps];    // walk bound: min(K, the cycle's length)
  int period[kMaxSweeps];         // the cycle's length
  int dr[kMaxSweeps];
  int dc[kMaxSweeps];
  int steps[kMaxSweeps];
  int count;
};

__host__ __device__ __forceinline__ int wrap_mod(long long v, int n) {
  long long r = v % n;
  return (int)(r < 0 ? r + n : r);
}

// A chunk's map from the value at its end to the value at its start:
// closed (c) at a break, the min up to it (v) and its distance (d); open,
// min(v, x) at d plus the input's distance. The identity is open, INT_MAX,
// 0.
struct ChunkMap {
  int v, d, c;
};

// f after g: f on the earlier positions, g on the later.
__device__ __forceinline__ ChunkMap compose(ChunkMap f, ChunkMap g) {
  if (f.c) return f;
  return {min(f.v, g.v), f.d + g.d, g.c};
}

__device__ __forceinline__ ChunkMap shfl_down(ChunkMap f, int off) {
  const unsigned full = 0xffffffffu;
  return {__shfl_down_sync(full, f.v, off), __shfl_down_sync(full, f.d, off),
          __shfl_down_sync(full, f.c, off)};
}

// A dr == 0 sweep whose reach covers its cycles (K >= period), on the
// CTA's rows: along each cycle x_k = q + k dc (mod cols) of a row, out_k =
// e_k ? min(l_k, out_{k+1}) : l_k with m_k = the links to the next break,
// the whole cycle's min where every link holds (the walk of the header
// with limit = period, and its npix term). One warp a cycle, ceil(period /
// 32), made odd, positions a lane: each lane's chunk as a ChunkMap,
// composed by a suffix scan of shuffles; the value at position 0 closes
// the cycle. From src into dst. Returns whether it lowered a valid
// pixel's label. The rows are the CTA's own (shared memory, or its slab
// of the global workspace), written by its own threads. A cycle's start
// position k dc is taken in 64 bits (the global route's rows reach 131071
// columns).
__device__ int row_scan(const int* src, int* dst, const unsigned char* bits,
                        const unsigned char* vld, int nrow, int cols, int dcw, int period,
                        long long reach, int steps, int npix, int s) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int cycles = cols / period;
  // odd, so that a warp's lanes, a chunk apart along a cycle of step 1 or
  // 2, meet in at most two shared-memory banks
  const int chunk = ((period + 31) / 32) | 1;
  const int k0 = min(period, lane * chunk);
  const int k1 = min(period, k0 + chunk);
  int changed = 0;
  for (int item = threadIdx.x >> 5; item < nrow * cycles; item += kWarps) {
    const int r = item / cycles;
    const int q = item - r * cycles;
    const int* lrow = src + r * cols;
    int* orow = dst + r * cols;
    const unsigned char* brow = bits + r * cols;
    const unsigned char* vrow = vld + r * cols;
    // the chunk's map; an empty chunk is the identity
    ChunkMap h = {INT_MAX, 0, 0};
    int col = (int)((q + (long long)k0 * dcw) % cols);
    for (int k = k0; k < k1; ++k) {
      h.v = min(h.v, lrow[col]);
      if (!((brow[col] >> s) & 1)) {
        h.c = 1;
        h.d = k - k0;
        break;
      }
      col += dcw;
      if (col >= cols) col -= cols;
    }
    if (!h.c) h.d = k1 - k0;
    // suffix scan: lane j holds chunk j's map composed with every later
    // chunk's
    for (int off = 1; off < 32; off *= 2) {
      const ChunkMap o = shfl_down(h, off);
      if (lane + off < 32) h = compose(h, o);
    }
    const ChunkMap p0 = {__shfl_sync(full, h.v, 0), __shfl_sync(full, h.d, 0),
                         __shfl_sync(full, h.c, 0)};
    // the value at the chunk's end: the later chunks' map applied to the
    // value at position 0
    ChunkMap nx = shfl_down(h, 1);
    if (lane == 31) nx = {INT_MAX, 0, 0};
    int cv = nx.c ? nx.v : min(nx.v, p0.v);
    int cd = nx.c ? nx.d : nx.d + p0.d;
    if (k1 > k0) col = (int)((q + (long long)(k1 - 1) * dcw) % cols);
    for (int k = k1 - 1; k >= k0; --k) {
      const int l = lrow[col];
      int o;
      if (!p0.c) {
        o = p0.v;           // every link holds: the cycle's min, no npix
      } else {
        if ((brow[col] >> s) & 1) {
          cv = min(l, cv);
          cd += 1;
        } else {
          cv = l;
          cd = 0;
        }
        o = cv;
        if (steps >= 2 && cd < period && cd <= reach - 2) o = min(o, npix);
      }
      orow[col] = o;
      changed |= vrow[col] && o < l;
      col -= dcw;
      if (col < 0) col += cols;
    }
  }
  return changed;
}

// Bytes of one CTA's slab of the global route's workspace: two int32
// label buffers, the edge bits and the valid bytes of span pixels, padded
// to 16 bytes.
__host__ __device__ __forceinline__ size_t slab_bytes(int span) {
  return ((size_t)kPixelBytes * span + 15) & ~(size_t)15;
}

// A label or edge byte that another CTA of the cluster wrote in an earlier
// sweep: through DSMEM (G false), or from its slab through L2, past this
// SM's L1 (G true).
template <bool G, typename T>
__device__ __forceinline__ T peer(const T* p) {
  if (G) return __ldcg(p);
  return *p;
}

// G: the image in a global workspace (`work`, slab_bytes(rpc * cols) a
// CTA, the cluster's slabs of an image side by side), not in shared memory
template <bool G>
__global__ void __launch_bounds__(kThreads, 1)
label_sweeps_kernel(const int* __restrict__ labels, const unsigned char* __restrict__ valid,
                    Sweeps sw, int rows, int cols, int rpc, int npix, int max_iters,
                    int* __restrict__ out, int* __restrict__ rounds_out, unsigned char* work) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flag[2];
  __shared__ int* rlab[2][kMaxCluster];
  __shared__ const unsigned char* rbits[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / cs;
  const int span = rpc * cols;
  unsigned char* const slab0 = G ? work + (size_t)img * cs * slab_bytes(span) : smem;
  unsigned char* const mine_slab = G ? slab0 + (size_t)rank * slab_bytes(span) : smem;
  int* buf[2];
  buf[0] = reinterpret_cast<int*>(mine_slab);
  buf[1] = buf[0] + span;
  unsigned char* bits = reinterpret_cast<unsigned char*>(buf[1] + span);
  unsigned char* vld = bits + span;
  const int row0 = rank * rpc;
  const int nrow = max(0, min(rpc, rows - row0));
  const int np = nrow * cols;
  const size_t base = (size_t)img * rows * cols + (size_t)row0 * cols;
  const int nt = kThreads;

  for (int i = threadIdx.x; i < np; i += nt) {
    buf[0][i] = labels[base + i];
    vld[i] = valid[base + i] != 0;
    unsigned b = 0;
    for (int s = 0; s < sw.count; ++s) b |= (unsigned)(sw.edges[s][base + i] != 0) << s;
    bits[i] = (unsigned char)b;
  }
  if (threadIdx.x < cs) {
    const int r = threadIdx.x;
    if (G) {
      int* b0 = reinterpret_cast<int*>(slab0 + (size_t)r * slab_bytes(span));
      rlab[0][r] = b0;
      rlab[1][r] = b0 + span;
      rbits[r] = reinterpret_cast<const unsigned char*>(b0 + 2 * span);
    } else {
      rlab[0][r] = r == rank ? buf[0] : cluster.map_shared_rank(buf[0], r);
      rlab[1][r] = r == rank ? buf[1] : cluster.map_shared_rank(buf[1], r);
      rbits[r] = r == rank ? bits : cluster.map_shared_rank(bits, r);
    }
  }
  cluster.sync();

  int cur = 0;
  int rounds = 0;
  bool live = max_iters > 0;
  while (live) {
    int changed = 0;
    for (int i = threadIdx.x; i < np; i += nt)
      changed |= !vld[i] && buf[cur][i] != npix;
    for (int s = 0; s < sw.count; ++s) {
      const int dr = sw.dr[s];
      const int dc = sw.dc[s];
      const int steps = sw.steps[s];
      if (dr == 0 && sw.limit[s] == sw.period[s]) {
        changed |= row_scan(buf[cur], buf[cur ^ 1], bits, vld, nrow, cols,
                            wrap_mod(dc, cols), sw.period[s], 1LL << (steps - 1), steps,
                            npix, s);
        cur ^= 1;
      } else {
        const int sr = wrap_mod(dr, rows);
        const int sc = wrap_mod(dc, cols);
        const long long limit = sw.limit[s];
        const long long reach = 1LL << (steps - 1);
        int* const* src = rlab[cur];
        const int* mine = buf[cur];
        int* dst = buf[cur ^ 1];
        int lr = threadIdx.x / cols;
        int c0 = threadIdx.x - lr * cols;
        const int step_r = nt / cols;
        const int step_c = nt - step_r * cols;
        for (int i = threadIdx.x; i < np; i += nt) {
          const int l = mine[i];
          int v = l;
          long long m = 0;
          if ((bits[i] >> s) & 1) {
            int r = row0 + lr;
            int c = c0;
            int owner = rank;
            int off = i;
            do {
              r += sr;
              if (r >= rows) r -= rows;
              c += sc;
              if (c >= cols) c -= cols;
              owner = r / rpc;
              off = (r - owner * rpc) * cols + c;
              v = min(v, peer<G>(src[owner] + off));
              ++m;
            } while (m < limit && ((peer<G>(rbits[owner] + off) >> s) & 1));
          }
          // a chain that broke after m edges: the doubling's broken gates
          if (steps >= 2 && m < limit && m <= reach - 2) v = min(v, npix);
          dst[i] = v;
          changed |= vld[i] && v < l;
          lr += step_r;
          c0 += step_c;
          if (c0 >= cols) {
            c0 -= cols;
            ++lr;
          }
        }
        cur ^= 1;
      }
      cluster.sync();
    }
    for (int i = threadIdx.x; i < np; i += nt)
      if (!vld[i]) buf[cur][i] = npix;
    ++rounds;
    const int any = __syncthreads_or(changed);
    if (threadIdx.x == 0) flag[rounds & 1] = any;
    cluster.sync();
    int img_any = 0;
    if (threadIdx.x < cs) img_any = *cluster.map_shared_rank(&flag[rounds & 1], (int)threadIdx.x);
    img_any = __syncthreads_or(img_any);
    live = img_any != 0 && rounds < max_iters;
  }
  for (int i = threadIdx.x; i < np; i += nt) out[base + i] = buf[cur][i];
  if (rank == 0 && threadIdx.x == 0) rounds_out[img] = rounds;
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

__host__ long long gcd_ll(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

__host__ size_t smem_bytes(int rows, int cols, int cs) {
  const int rpc = (rows + cs - 1) / cs;
  return (size_t)kPixelBytes * rpc * cols;
}

__host__ cudaLaunchConfig_t make_config(int bsz, int cs, size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bsz * cs), 1, 1);
  cfg.blockDim = dim3((unsigned)kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for a layout: its shared memory, and clusters
// past 8 CTAs allowed.
template <bool G>
__host__ cudaError_t set_attributes(int cs, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(label_sweeps_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || cs <= 8) return err;
  return cudaFuncSetAttribute(label_sweeps_kernel<G>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool G>
__host__ int resident_clusters(int bsz, int cs, size_t smem) {
  if (set_attributes<G>(cs, smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(bsz, cs, smem, nullptr, &attr);
  int resident = 0;
  if (cudaOccupancyMaxActiveClusters(&resident, label_sweeps_kernel<G>, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return resident;
}

constexpr int kInfo = 5;

// The layout for bsz images of rows x cols: of clusters of 16 and 8 CTAs
// (at most the row count, and 4, 2, 1 below that), those whose CTAs'
// shared memory fits and of which at least one cluster can be resident
// (cudaOccupancyMaxActiveClusters), the one with the fewest waves of
// clusters per CTA of a cluster, ceil(bsz / resident) / cs (the larger
// cluster on a tie). Where none fits (an image of few rows and many
// columns), the global route: a cluster of the largest of 8, 4, 2, 1 CTAs
// within the row count, each CTA's rows in a slab of a global workspace.
// info: {cluster size, bytes a CTA (its dynamic shared memory, or its
// slab of the workspace), resident clusters, the limit of dynamic shared
// bytes a CTA, the route (0 shared, 1 global)}.
__host__ int choose_layout(int bsz, int rows, int cols, int* info) {
  // the last answer, per device: a call at the same shape asks nothing
  static int seen[4] = {-1, 0, 0, 0};
  static int seen_info[kInfo];
  int device = 0;
  cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return (int)derr;
  if (seen[0] == device && seen[1] == bsz && seen[2] == rows && seen[3] == cols) {
    for (int k = 0; k < kInfo; ++k) info[k] = seen_info[k];
    return 0;
  }
  int best = 0;
  double best_cost = 0.0;
  info[3] = kDynSmemLimit;
  info[4] = 0;
  for (int cs = kMaxCluster; cs >= 1; cs /= 2) {
    if (cs > rows && cs > 1) continue;
    const size_t smem = smem_bytes(rows, cols, cs);
    if (smem > (size_t)kDynSmemLimit) continue;
    const int resident = resident_clusters<false>(bsz, cs, smem);
    if (resident >= 1) {
      const double cost = (double)((bsz + resident - 1) / resident) / cs;
      if (best == 0 || cost < best_cost) {
        best = cs;
        best_cost = cost;
        info[0] = cs;
        info[1] = (int)smem;
        info[2] = resident;
      }
    }
    // the layouts only get smaller from here; 16 and 8 cover the presets
    if (cs <= 8 && best != 0) break;
  }
  if (best == 0) {
    int cs = 8;
    while (cs > rows && cs > 1) cs /= 2;
    const int rpc = (rows + cs - 1) / cs;
    const size_t slab = slab_bytes(rpc * cols);
    const int resident = resident_clusters<true>(bsz, cs, 0);
    if (resident < 1 || slab > (size_t)INT_MAX) return (int)cudaErrorInvalidConfiguration;
    info[0] = cs;
    info[1] = (int)slab;
    info[2] = resident;
    info[4] = 1;
  }
  seen[0] = device;
  seen[1] = bsz;
  seen[2] = rows;
  seen[3] = cols;
  for (int k = 0; k < kInfo; ++k) seen_info[k] = info[k];
  return 0;
}

}  // namespace quatro

// The layout quatro_label_sweep takes for bsz images of rows x cols: info
// (host int[5]) = {cluster size, bytes a CTA (dynamic shared memory, or
// its slab of the global route's workspace), resident clusters, the limit
// of dynamic shared bytes a CTA, the route (0 shared memory, 1 a global
// workspace of bsz x cluster x slab bytes)}. Returns
// cudaErrorInvalidConfiguration where not even the global route can be
// resident; another CUDA error where the card cannot be asked.
extern "C" int quatro_label_layout(int bsz, int rows, int cols, int* info) {
  using namespace quatro;
  if (bsz <= 0 || rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  return choose_layout(bsz, rows, cols, info);
}

// labels, valid (B, R, C); edge_ptrs (host, nsweeps device pointers of
// (B, R, C) bool masks); sched (host, nsweeps x (dr, dc, steps)); out
// (B, R, C) int32, rounds (B,) int32; work: the global route's workspace
// (B x cluster x slab bytes, 16-byte aligned; unread on the shared route).
// One launch, in the layout quatro_label_layout reports.
extern "C" int quatro_label_sweep(const int* labels, const unsigned char* valid,
                                  const long long* edge_ptrs, const int* sched, int nsweeps,
                                  int bsz, int rows, int cols, int npix, int max_iters,
                                  int* out, int* rounds, unsigned char* work,
                                  cudaStream_t stream) {
  using namespace quatro;
  if (bsz <= 0 || rows <= 0 || cols <= 0) return 0;
  if (nsweeps < 1 || nsweeps > kMaxSweeps || max_iters < 0) return (int)cudaErrorInvalidValue;
  Sweeps sw = {};
  sw.count = nsweeps;
  for (int s = 0; s < nsweeps; ++s) {
    const int dr = sched[3 * s], dc = sched[3 * s + 1], steps = sched[3 * s + 2];
    if (steps < 1 || steps > 40) return (int)cudaErrorInvalidValue;
    sw.edges[s] = reinterpret_cast<const unsigned char*>(edge_ptrs[s]);
    sw.dr[s] = dr;
    sw.dc[s] = dc;
    sw.steps[s] = steps;
    // the cycle of positions i, i + d, ... on the (rows, cols) torus
    const long long pr = rows / gcd_ll(wrap_mod(dr, rows), rows);
    const long long pc = cols / gcd_ll(wrap_mod(dc, cols), cols);
    const long long period = pr / gcd_ll(pr, pc) * pc;
    const long long reach = 1LL << (steps - 1);
    sw.limit[s] = reach < period ? reach : period;
    sw.period[s] = (int)period;
  }
  int info[kInfo];
  cudaError_t e = (cudaError_t)choose_layout(bsz, rows, cols, info);
  if (e != cudaSuccess) return (int)e;
  const int cs = info[0];
  const bool global = info[4] != 0;
  if (global && work == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = global ? 0 : (size_t)info[1];
  e = global ? set_attributes<true>(cs, smem) : set_attributes<false>(cs, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = make_config(bsz, cs, smem, stream, &attr);
  const int rpc = (rows + cs - 1) / cs;
  if (global)
    e = cudaLaunchKernelEx(&cfg, label_sweeps_kernel<true>, labels, valid, sw, rows, cols, rpc,
                           npix, max_iters, out, rounds, work);
  else
    e = cudaLaunchKernelEx(&cfg, label_sweeps_kernel<false>, labels, valid, sw, rows, cols, rpc,
                           npix, max_iters, out, rounds, (unsigned char*)nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
