// The range-image labelling's per-component size and line count, and the
// feasibility they gate.
//
// The counterpart of quatro_tpu/preprocessing/projection.py::
// label_components' stats (:279-318: one (label, row) sort, cummax /
// cummin scans and a sort back; XLA's sorts and loop fusions, no Pallas
// kernel there), bit for bit quatro_tpu_torch/ops/range_image.py::
// component_stats_plain (that sort-scan route in torch operations).
//
// labels (B, R, C) int32 (a valid pixel's label in [0, npix]: the min flat
// index of its component, npix for none) and valid (B, R, C) bool ->
// labels_out (B, R, C) int64 (the label, -1 where not valid), pix_feasible
// (B, R, C) bool and feasible (B, R * C) bool (pix_feasible at each
// component's root pixel, the pixel whose flat index is its label). A
// component l < npix is feasible where size >= min_pts or (size >=
// valid_num and lines >= valid_lines), lines = rmax - rmin + 1 (its rows
// are contiguous under |dr| <= 1 neighbours, so this is the sort-scan
// route's count: both take the span).
//
// Bound on the card: bytes. labels and valid read once (5 bytes a pixel)
// and the outputs written once (10): at path P's B = 64 (128 images of 64
// x 1800) 221 MB, 0.066 ms at 3.35 TB/s.
// Design: integer atomics, which are order-free and so exact and
// repeatable: per label a count, a max of R - row and a max of row + 1
// (all 0 for no pixel, so a memset clears them), summed by one thread a
// pixel, each warp's pixels of one label merged first (__match_any_sync,
// then one atomic of each kind from the group's first lane); a second
// pass reads each valid pixel's label's three words. Scratch: 12 bytes a
// pixel, cleared by cudaMemsetAsync.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kStatsThreads = 256;

__global__ void __launch_bounds__(kStatsThreads)
component_accumulate_kernel(const int* __restrict__ labels, const bool* __restrict__ valid,
                            int rows, int cols, int* __restrict__ count,
                            int* __restrict__ top, int* __restrict__ bottom) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const int npix = rows * cols;
  int lab = -1, row = 0;
  if (p < npix && valid[b * npix + p]) {
    const int l = labels[b * npix + p];
    if (l >= 0 && l < npix) {
      lab = l;
      row = p / cols;
    }
  }
  const unsigned group = __match_any_sync(0xFFFFFFFFu, lab);
  if (lab < 0) return;
  const int rlo = __reduce_min_sync(group, row);
  const int rhi = __reduce_max_sync(group, row);
  if ((threadIdx.x & 31) != __ffs(group) - 1) return;
  const size_t slot = b * npix + lab;
  atomicAdd(count + slot, __popc(group));
  atomicMax(top + slot, rows - rlo);
  atomicMax(bottom + slot, rhi + 1);
}

__global__ void __launch_bounds__(kStatsThreads)
component_feasible_kernel(const int* __restrict__ labels, const bool* __restrict__ valid,
                          int rows, int cols, int min_pts, int valid_num, int valid_lines,
                          const int* __restrict__ count, const int* __restrict__ top,
                          const int* __restrict__ bottom, long long* __restrict__ labels_out,
                          bool* __restrict__ feasible, bool* __restrict__ pix_feasible) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const int npix = rows * cols;
  if (p >= npix) return;
  const size_t i = b * npix + p;
  const bool v = valid[i];
  const int l = labels[i];
  bool feas = false;
  if (v && l >= 0 && l < npix) {
    const size_t slot = b * npix + l;
    const int size = count[slot];
    const int lines = bottom[slot] + top[slot] - rows;   // rmax - rmin + 1
    feas = size >= min_pts || (size >= valid_num && lines >= valid_lines);
  }
  labels_out[i] = v ? (long long)l : -1;
  pix_feasible[i] = feas;
  feasible[i] = feas && l == p;
}

}  // namespace quatro

// scratch: int32 (3, B, R * C), cleared here.
extern "C" int quatro_component_stats(const int* labels, const bool* valid, int bsz, int rows,
                                      int cols, int min_pts, int valid_num, int valid_lines,
                                      int* scratch, long long* labels_out, bool* feasible,
                                      bool* pix_feasible, cudaStream_t stream) {
  using namespace quatro;
  const size_t words = (size_t)bsz * rows * cols;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 3 * words * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  int *count = scratch, *top = scratch + words, *bottom = scratch + 2 * words;
  dim3 grid((rows * cols + kStatsThreads - 1) / kStatsThreads, bsz);
  component_accumulate_kernel<<<grid, kStatsThreads, 0, stream>>>(labels, valid, rows, cols,
                                                                  count, top, bottom);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  component_feasible_kernel<<<grid, kStatsThreads, 0, stream>>>(
      labels, valid, rows, cols, min_pts, valid_num, valid_lines, count, top, bottom,
      labels_out, feasible, pix_feasible);
  return (int)cudaGetLastError();
}
