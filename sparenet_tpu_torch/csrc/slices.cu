// The plan of the slice kernels (slices.cuh: gather_max.cu's and
// edge_stats.cu's) for the Python bindings (sparenet_tpu_torch/ops/
// common.py:slice_plan).
#include "slices.cuh"

// out = {width (0: the row path), row groups, rows a group, threads, rows a
// chunk, shared memory bytes, blocks} of a [B, N, C] table and [B, M, k]
// lists on the current card.
extern "C" int spn_slice_plan(int batch, int n, int m, int c, int k, int* out) {
  spn::slices::Plan p;
  const cudaError_t err = spn::slices::make_plan(batch, n, m, c, k, &p);
  const int v[7] = {p.width, p.groups, p.group_rows, p.threads, p.lanes,
                    p.smem, p.blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return (int)err;
}
