// The final Patchwork classification: one int32 code per point.
//
// Replaces quatro_tpu/ops/segment_matmul.py::classify_points
// (_classify_kernel). Per point with patch id p and delivered row
// [n1, n2, n3, th, flags] = tab[b, p] (zeros outside [0, p_pad)):
//   fl = (int)(flags + 0.5), live = p < p_cnt and fl & 8,
//   isg = (n1 x + n2 y) + n3 z < th,
//   g = live and fl & 1 and isg, ng = live and not g,
//   rev = live and fl & 2 and isg, rej = live and fl & 4 and isg,
//   code = g + 2 ng + 4 rev + 8 rej,
// chan (B, 5, N) = [x, y, z, px, py], out (B, N) int32. The TPU kernel
// delivers the row through a one-hot MXU contraction; here each point
// reads its row.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072) ids, x,
// y, z, the table and the codes are 4.2 MB, 1.3 us at 3.35 TB/s.
// Design: one thread per point, the projection with the round-to-nearest
// intrinsics in the plain version's order, so the codes equal the plain
// version's exactly.
#include <cuda_runtime.h>

#include "patchwork.cuh"

namespace quatro {

constexpr int kClassifyThreads = 256;

__global__ void __launch_bounds__(kClassifyThreads)
classify_kernel(const int* __restrict__ ids, const float* __restrict__ chan,
                const float* __restrict__ tab, int n, int p_pad, int p_cnt,
                int* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= n) return;
  const int id = ids[(size_t)b * n + e];
  const float* cb = chan + (size_t)b * kTabCols * n;
  float row[kTabCols];
  deliver_row(tab + (size_t)b * p_pad * kTabCols, p_pad, id, row);
  const bool isg = plane_proj(row, cb[e], cb[(size_t)n + e], cb[2 * (size_t)n + e]) < row[3];
  const int fl = (int)add(row[4], 0.5f);
  const bool live = id < p_cnt && (fl & 8) != 0;
  const bool g = live && (fl & 1) != 0 && isg;
  const bool ng = live && !g;
  const bool rev = live && (fl & 2) != 0 && isg;
  const bool rej = live && (fl & 4) != 0 && isg;
  out[(size_t)b * n + e] = (int)g + 2 * (int)ng + 4 * (int)rev + 8 * (int)rej;
}

}  // namespace quatro

// ids (B, N) int32, chan (B, 5, N) f32, tab (B, p_pad, 5) f32 -> out (B, N)
// int32.
extern "C" int quatro_classify_points(const int* ids, const float* chan, const float* tab,
                                      int bsz, int n, int p_pad, int p_cnt, int* out,
                                      cudaStream_t stream) {
  dim3 grid((n + quatro::kClassifyThreads - 1) / quatro::kClassifyThreads, bsz);
  quatro::classify_kernel<<<grid, quatro::kClassifyThreads, 0, stream>>>(
      ids, chan, tab, n, p_pad, p_cnt, out);
  return (int)cudaGetLastError();
}
