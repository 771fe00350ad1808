// Per-point read of the range image's packed pixel words.
//
// Replaces quatro_tpu/ops/segment_matmul.py::image_lookup
// (_imglookup_kernel): out[b, i] = img[b, flat[b, i]], 0 for ids outside
// [0, npix); flat (B, N) int32, img (B, npix) int32, out (B, N) int32. The
// TPU kernel reads the image through a row one-hot MXU contraction and a
// column one-hot select, in f32 split three ways, because a gather of N
// indices from an image-sized table is slow there; on the card it is a
// plain gather of the int32 words.
//
// Bound on the card: bytes. On the main path (B = 2, N = 131072, 64 x 1800
// pixels) ids, image and output are 3.0 MB, 0.9 us at 3.35 TB/s.
// Design: one thread per point.
#include <cuda_runtime.h>

namespace quatro {

constexpr int kLookupThreads = 256;

__global__ void __launch_bounds__(kLookupThreads)
image_lookup_kernel(const int* __restrict__ flat, const int* __restrict__ img, int n,
                    int npix, int* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= n) return;
  const int f = flat[(size_t)b * n + e];
  out[(size_t)b * n + e] = (f >= 0 && f < npix) ? img[(size_t)b * npix + f] : 0;
}

}  // namespace quatro

extern "C" int quatro_image_lookup(const int* flat, const int* img, int bsz, int n, int npix,
                                   int* out, cudaStream_t stream) {
  dim3 grid((n + quatro::kLookupThreads - 1) / quatro::kLookupThreads, bsz);
  quatro::image_lookup_kernel<<<grid, quatro::kLookupThreads, 0, stream>>>(flat, img, n,
                                                                           npix, out);
  return (int)cudaGetLastError();
}
