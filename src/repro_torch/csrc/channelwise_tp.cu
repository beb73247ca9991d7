// Fused channelwise tensor product + edge->atom scatter (paper Algorithm 2),
// forward and backward, over the data pipeline's receiver-sorted edge tiles,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   forward  src/repro/kernels/channelwise_tp/kernel.py::_tp_scatter_kernel
//   backward src/repro/kernels/channelwise_tp/kernel.py::_tp_gather_bwd_kernel
//
// Layout (k minor; E_p = n_tiles * epb edge slots, slot s in tile s / epb):
//   Y     [E_p, d_sh]          spherical harmonics of each slot's edge
//   h     [E_p, d_h, k]        sender features gathered to the slots
//   R     [E_p, n_paths, k]    radial weights per path
//   local [E_p] int32          receiver row inside the tile, in [0, block_n)
//   valid [E_p] uint8          0 for padding slots
//   out   [n_tiles * block_n, d_out, k]   per-tile receiver rows
//   G     (backward) the cotangent of out;  dY, dh, dR shapes of Y, h, R
//
// CG table, read at run time (built once per spec and cached per device by
// repro_torch/kernels/channelwise_tp/kernel.py::device_tables):
//   ent [n_ent, 4] int32 (m1, m2, m3, path),  ent_val [n_ent] float
// Each block copies it into shared memory first.
//
// What bounds it on this card: bytes.  Each valid slot reads
// (d_h + n_paths) * k floats of h and R (14 * 128 * 4 = 7 KB at the paper's
// width, layer 1) for 4 flops per CG entry per channel (86 entries):
// about 6 flops per byte, below the fp32 ridge of 20 flops per byte.
//
// Forward design: one block per tile, one thread per channel.  A thread owns
// its channel of the tile's [block_n, d_out] output rows, so the scatter
// needs neither atomics nor a shared-memory reduction: the thread walks the
// tile's slots in order, sums the messages of a run of slots with the same
// receiver in registers, and adds the run into the (zeroed) output row when
// the receiver changes.  Slots are receiver-sorted inside a tile, so each row
// is written about once; an unsorted tile would still be right, only slower.
// Masked slots are skipped, and a tile with no valid slot (padding tiles,
// base = n_atoms) stays exactly zero.  Hub atoms spanning several tiles get
// one partial row per tile; the wrapper folds tiles sharing a base.
// The sums run over slots in slot order and over CG entries in table order,
// deterministically; the plain version sums each slot's entries first and
// then the slots (index_add_), so the two agree to fp32 rounding of sums of
// up to epb * n_ent terms: the stated tolerance is 2e-5 of the output's
// largest magnitude (chip_smoke.py).  The grid has only n_tiles blocks (104 for the
// 256-atom bucket), which leaves most of the card idle: splitting a tile's
// slots over more threads is later work.
//
// Backward design: one block per slot, one thread per channel.  The thread
// gathers its receiver's cotangent row (the transpose of the scatter),
// then runs the TP transpose over the CG entries:
//   dh[m2] += val * Y[m1] * R[p] * g[m3],  dR[p] += val * Y[m1] * h[m2] * g[m3]
// into its own channel of the slot's dh and dR rows, and keeps
//   dY[m1] += val * g[m3] * h[m2] * R[p]
// in registers; dY is then summed over the channels by a warp-shuffle
// reduction and one shared-memory pass across the warps.  Masked slots write
// exact zeros.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_D = 32;  // the wrapper refuses d_sh or d_out above this

__device__ __forceinline__ void load_table(int4* s_ent, float* s_val,
                                           const int* ent,
                                           const float* ent_val, int n_ent) {
  for (int i = threadIdx.x; i < n_ent; i += blockDim.x) {
    s_ent[i] = make_int4(ent[4 * i], ent[4 * i + 1], ent[4 * i + 2],
                         ent[4 * i + 3]);
    s_val[i] = ent_val[i];
  }
}

__global__ void tp_scatter_kernel(
    const float* __restrict__ Y, const float* __restrict__ h,
    const float* __restrict__ R, const int* __restrict__ local,
    const unsigned char* __restrict__ valid, float* __restrict__ out,
    const int* __restrict__ ent, const float* __restrict__ ent_val, int n_ent,
    int epb, int block_n, int d_sh, int d_h, int n_paths, int d_out, int k) {
  extern __shared__ int4 smem[];
  int4* s_ent = smem;
  float* s_val = reinterpret_cast<float*>(s_ent + n_ent);
  load_table(s_ent, s_val, ent, ent_val, n_ent);
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= k) return;
  const long tile = blockIdx.x;
  float* o_tile = out + tile * block_n * d_out * k + c;
  for (int r = 0; r < block_n * d_out; ++r) o_tile[static_cast<long>(r) * k] = 0.f;

  float acc[MAX_D];
  int cur = -1;
  for (int j = 0; j < epb; ++j) {
    const long s = tile * epb + j;
    if (!valid[s]) continue;
    const int r = local[s];
    if (r != cur) {
      if (cur >= 0) {
        for (int m = 0; m < d_out; ++m)
          o_tile[(static_cast<long>(cur) * d_out + m) * k] += acc[m];
      }
      for (int m = 0; m < d_out; ++m) acc[m] = 0.f;
      cur = r;
    }
    const float* y = Y + s * d_sh;
    const float* hs = h + s * d_h * k + c;
    const float* rs = R + s * n_paths * k + c;
    for (int e = 0; e < n_ent; ++e) {
      const int4 q = s_ent[e];  // (m1, m2, m3, path)
      acc[q.z] += (y[q.x] * s_val[e]) * hs[static_cast<long>(q.y) * k] *
                  rs[static_cast<long>(q.w) * k];
    }
  }
  if (cur >= 0) {
    for (int m = 0; m < d_out; ++m)
      o_tile[(static_cast<long>(cur) * d_out + m) * k] += acc[m];
  }
}

__global__ void tp_gather_bwd_kernel(
    const float* __restrict__ G, const float* __restrict__ Y,
    const float* __restrict__ h, const float* __restrict__ R,
    const int* __restrict__ local, const unsigned char* __restrict__ valid,
    float* __restrict__ dY, float* __restrict__ dh, float* __restrict__ dR,
    const int* __restrict__ ent, const float* __restrict__ ent_val, int n_ent,
    int epb, int block_n, int d_sh, int d_h, int n_paths, int d_out, int k) {
  extern __shared__ int4 smem[];
  int4* s_ent = smem;
  float* s_val = reinterpret_cast<float*>(s_ent + n_ent);
  float* s_red = s_val + n_ent;  // [n_warps, d_sh]
  load_table(s_ent, s_val, ent, ent_val, n_ent);
  __syncthreads();

  const long s = blockIdx.x;
  const int c = threadIdx.x;
  const bool on = valid[s] != 0;
  float dy[MAX_D];
  for (int m = 0; m < d_sh; ++m) dy[m] = 0.f;

  if (c < k) {
    float* dh_s = dh + s * d_h * k + c;
    float* dr_s = dR + s * n_paths * k + c;
    for (int m = 0; m < d_h; ++m) dh_s[static_cast<long>(m) * k] = 0.f;
    for (int p = 0; p < n_paths; ++p) dr_s[static_cast<long>(p) * k] = 0.f;
    if (on) {
      const long row = (s / epb) * block_n + local[s];
      const float* g_row = G + row * d_out * k + c;
      const float* y = Y + s * d_sh;
      const float* hs = h + s * d_h * k + c;
      const float* rs = R + s * n_paths * k + c;
      for (int e = 0; e < n_ent; ++e) {
        const int4 q = s_ent[e];  // (m1, m2, m3, path)
        const float val = s_val[e];
        const float gm = g_row[static_cast<long>(q.z) * k];
        const float hv = hs[static_cast<long>(q.y) * k];
        const float rv = rs[static_cast<long>(q.w) * k];
        const float yv = y[q.x] * val;
        dy[q.x] += gm * hv * rv * val;
        dh_s[static_cast<long>(q.y) * k] += (gm * rv) * yv;
        dr_s[static_cast<long>(q.w) * k] += (gm * hv) * yv;
      }
    }
  }

  // dY: sum the per-channel partials over the block (threads past k and
  // masked slots hold zeros)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int m = 0; m < d_sh; ++m) {
    float v = dy[m];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp * d_sh + m] = v;
  }
  __syncthreads();
  if (threadIdx.x < d_sh) {
    float total = 0.f;
    for (int w = 0; w < n_warps; ++w) total += s_red[w * d_sh + threadIdx.x];
    dY[s * d_sh + threadIdx.x] = total;
  }
}

int threads_for(int k) { return ((k + 31) / 32) * 32; }

}  // namespace

extern "C" int tp_scatter_fwd(const float* Y, const float* h, const float* R,
                              const int* local, const unsigned char* valid,
                              float* out, const int* ent, const float* ent_val,
                              int n_ent, int n_tiles, int epb, int block_n,
                              int d_sh, int d_h, int n_paths, int d_out, int k,
                              cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_ent) * (sizeof(int4) + sizeof(float));
  tp_scatter_kernel<<<n_tiles, threads_for(k), smem, stream>>>(
      Y, h, R, local, valid, out, ent, ent_val, n_ent, epb, block_n, d_sh, d_h,
      n_paths, d_out, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tp_gather_bwd(const float* G, const float* Y, const float* h,
                             const float* R, const int* local,
                             const unsigned char* valid, float* dY, float* dh,
                             float* dR, const int* ent, const float* ent_val,
                             int n_ent, int n_tiles, int epb, int block_n,
                             int d_sh, int d_h, int n_paths, int d_out, int k,
                             cudaStream_t stream) {
  const int threads = threads_for(k);
  const size_t smem =
      static_cast<size_t>(n_ent) * (sizeof(int4) + sizeof(float)) +
      static_cast<size_t>(threads / 32) * d_sh * sizeof(float);
  tp_gather_bwd_kernel<<<n_tiles * epb, threads, smem, stream>>>(
      G, Y, h, R, local, valid, dY, dh, dR, ent, ent_val, n_ent, epb, block_n,
      d_sh, d_h, n_paths, d_out, k);
  return static_cast<int>(cudaGetLastError());
}
