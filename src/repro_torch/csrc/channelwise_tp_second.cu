// Second order of the blocked interaction (paper Algorithm 2): the VJP of the
// backward's map (g, Y, h, R) -> (dY, dh, dR) over the data pipeline's
// receiver-sorted edge tiles, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes this derivative of its
// blocked backward (src/repro/kernels/channelwise_tp/ops.py::_blocked_bwd_op)
// by autodiff of the pure-XLA twin interaction_fused, which XLA fuses under
// jit.  Training needs it at every step, since forces in the loss make each
// step a grad-of-grad; eager autograd over that twin built about a dozen
// [edges, k, nnz] tensors per chunk of edges, one-hot gathers and scatters.
//
// With cotangents (cY, ch, cR) of (dY, dh, dR), ge = mask g[receiver] / avg,
// and sums over the CG entries (m1, m2, m3, p, val):
//   dg[row, m3] = sum over the row's slots of
//                 val (cY[m1] h[m2] R[p] + Y[m1] ch[m2] R[p] + Y[m1] h[m2] cR[p])
//   dY[e, m1]   = sum_c val ge[m3] (ch[m2] R[p] + h[m2] cR[p])
//   dR[e, p]    = val ge[m3] (cY[m1] h[m2] + Y[m1] ch[m2])
//   dh[s, m2]   = val ge[m3] (cY[m1] R[p] + Y[m1] cR[p])     (per slot)
// The wrapper folds dg's tile rows onto atom rows (as the forward's rows)
// and sums dh over each slot's sender.
//
// Layout (k minor; E_p = n_tiles * epb edge slots, slot s in tile s / epb):
//   Y, cY  [E, d_sh]         edge order: read through perm
//   h, ch  [N, d_h, k]       node order: read through send (senders[perm])
//   R, cR  [E, n_paths, k]   edge order: read through perm
//   G      [N, d_out, k]     the cotangent rows g / avg, read at row
//                            base[tile] + local[s] (a valid slot's receiver)
//   perm, send, local [E_p] int32, valid [E_p] uint8, base [n_tiles] int32
//   dG     [n_tiles * block_n, d_out, k]   tile rows (scatter)
//   dY [E, d_sh], dR [E, n_paths, k]       edge order: each valid slot writes
//                                          its edge's rows (the valid slots
//                                          are a permutation of the valid
//                                          edges); the wrapper zeroes the rest
//   dh     [E_p, d_h, k]     per slot, exact zeros for masked slots
// No [E_p, ...] copy of an operand is made: each slot reads its edge's and
// its sender's rows in place.
//
// Built once per tensor-product spec with the header KERNEL_HEADER that
// repro_torch/kernels/channelwise_tp/kernel.py::second_order_header
// generates: D_SH, D_H, N_P, D_OUT, the CG entries unrolled into
// straight-line scalar sums over operands in registers, grouped by one index
// (tp_dbl_messages by m3; tp_dbl_dh by m2, tp_dbl_dr by path, tp_dbl_dy by
// m1), GATHER_OUTS, the outputs each launch of the gather computes, and
// SCATTER_MIN_BLOCKS, the scatter's blocks an SM (2: 128 registers a thread;
// 1 where its operands and sums need more: MACE-MP-0 large's layer 1).  Each
// output reads four of the six operand rows (dR: Y, cY, h, ch; dh: Y, cY, R,
// cR; dY: h, ch, R, cR) and g; a spec whose operands and sums do not fit the
// registers in one launch (MACE-MP-0 large's layer 1) takes one launch per
// output, each with only its operands live.  fp32 whatever the first order's
// precision, as the autograd twin was.
//
// Scatter design: the forward's (csrc/channelwise_tp.cu): grid (tile, group
// of 32 channels), a lane per channel; the block sorts the tile's valid
// slots by receiver row, each warp sums an equal segment of the sorted slots
// and writes the rows inside it, a row cut by a segment boundary is summed
// in warp order through shared memory.  A tile with no valid slot writes
// zeros and reads nothing else.
// Gather design: the first-order backward's: one thread per (slot, channel),
// a block owns GTH_SLOTS consecutive slots; dY is summed over the channels
// by warp shuffles, then over the warps in order through shared memory.
// Masked slots write dh's zeros and do no arithmetic.
//
// Determinism: no atomics; every sum runs in a fixed order, so two launches
// give bit-identical outputs.  The plain versions sum in another order: the
// tolerance is 2e-5 of the output's largest magnitude.
//
// What bounds both on this card: bytes.  A valid slot reads 2 (d_h + n_paths)
// k floats of operand rows (h and ch mostly from L2: the node rows are 6 MB
// at 3,072 atoms) and, in the gather, its receiver's g row, for 9 (scatter)
// or 18 (gather) flops per CG entry and channel.  ptxas must report 0 bytes
// of stack frame and spills at the paper's specs (chip_smoke.py).
#include <cuda_runtime.h>

#ifndef KERNEL_HEADER
#error "build with -DKERNEL_HEADER=<header from kernel.py::second_order_header>"
#endif
#include KERNEL_HEADER

static_assert(D_SH <= 32 && D_H <= 32 && D_OUT <= 32,
              "a slot's Y is spread from one lane per component");

namespace {

constexpr int SCT_WARPS = 8;      // segments of a tile summed at once
constexpr int GTH_THREADS = 128;  // channels of a slot summed at once
constexpr int GTH_SLOTS = 4;      // slots of one gather block
constexpr int MAX_EPB = 1024;     // slots of a tile the scatter can sort
constexpr unsigned FULL = 0xffffffffu;
// the outputs of a gather launch (GATHER_OUTS)
constexpr int OUT_DR = 1, OUT_DH = 2, OUT_DY = 4;

template <int N>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, long row, int k,
                                          int c, bool ok, float (&v)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = ok ? __ldg(src + (row * N + m) * k + c) : 0.f;
}

// a row of D_SH values, one lane per component, spread to every lane
__device__ __forceinline__ void load_spread(const float* __restrict__ src, long row,
                                            float (&v)[D_SH]) {
  const int lane = threadIdx.x & 31;
  const float l = lane < D_SH ? __ldg(src + row * D_SH + lane) : 0.f;
#pragma unroll
  for (int m = 0; m < D_SH; ++m) v[m] = __shfl_sync(FULL, l, m);
}

// ---------------------------------------------------------------------------
// dg: receiver scatter of the slots' messages
// ---------------------------------------------------------------------------

__device__ __forceinline__ int seg_lo(int w, int n_valid) {
  return static_cast<int>((static_cast<long>(w) * n_valid) / SCT_WARPS);
}

__global__ void __launch_bounds__(SCT_WARPS * 32, SCATTER_MIN_BLOCKS)
tp_dbl_scatter_kernel(
    const float* __restrict__ Y, const float* __restrict__ cY,
    const float* __restrict__ h, const float* __restrict__ ch,
    const float* __restrict__ R, const float* __restrict__ cR,
    const int* __restrict__ perm, const int* __restrict__ send,
    const int* __restrict__ local, const unsigned char* __restrict__ valid,
    float* __restrict__ out, int epb, int block_n, int k) {
  extern __shared__ float smem_f[];
  float* s_part = smem_f;              // [SCT_WARPS][2][D_OUT][32] cut rows
  int* s_row = reinterpret_cast<int*>(s_part + SCT_WARPS * 2 * D_OUT * 32);
  int* s_sorted = s_row + epb;         // [epb] valid slots by (row, slot)
  int* s_start = s_sorted + epb;       // [block_n + 1] first position of a row
  int* s_part_row = s_start + block_n + 1;  // [SCT_WARPS][2] row of a partial
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y * 32 + lane;
  const bool ok = c < k;
  const long tile = blockIdx.x, s0 = tile * epb;
  float* o = out + tile * block_n * D_OUT * static_cast<long>(k) + c;
  auto write_row = [&](int r, const float (&v)[D_OUT]) {
    if (ok) {
#pragma unroll
      for (int m = 0; m < D_OUT; ++m) o[(static_cast<long>(r) * D_OUT + m) * k] = v[m];
    }
  };

  for (int j = tid; j < epb; j += SCT_WARPS * 32)
    s_row[j] = valid[s0 + j] ? local[s0 + j] : -1;
  __syncthreads();

  // counting sort of the valid slots by row, slot order inside a row; rows
  // without a slot are written as zeros on the way
  for (int r = warp; r < block_n; r += SCT_WARPS) {
    int n = 0;
    for (int j0 = 0; j0 < epb; j0 += 32)
      n += __popc(__ballot_sync(FULL, j0 + lane < epb && s_row[j0 + lane] == r));
    if (lane == 0) s_start[r + 1] = n;
    if (n == 0) {
      float zero[D_OUT];
#pragma unroll
      for (int m = 0; m < D_OUT; ++m) zero[m] = 0.f;
      write_row(r, zero);
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_start[0] = 0;
    for (int r = 0; r < block_n; ++r) s_start[r + 1] += s_start[r];
  }
  __syncthreads();
  const int n_valid = s_start[block_n];
  if (n_valid == 0) return;  // a padding tile: zeros written, nothing read
  for (int r = warp; r < block_n; r += SCT_WARPS) {
    int n = s_start[r];
    for (int j0 = 0; j0 < epb; j0 += 32) {
      const bool hit = j0 + lane < epb && s_row[j0 + lane] == r;
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) s_sorted[n + __popc(m & ((1u << lane) - 1u))] = j0 + lane;
      n += __popc(m);
    }
  }
  if (lane < 2) s_part_row[warp * 2 + lane] = -1;
  __syncthreads();

  // each warp sums an equal segment of the sorted slots: a row inside the
  // segment is written at once, a row cut by a segment boundary leaves its
  // partial sum (at most one at each end) for the fix-up below
  const int lo = seg_lo(warp, n_valid), hi = seg_lo(warp + 1, n_valid);
  if (lo < hi) {
    float sum[D_OUT];
#pragma unroll
    for (int m = 0; m < D_OUT; ++m) sum[m] = 0.f;
    int cur = s_row[s_sorted[lo]];
    for (int pos = lo; pos < hi; ++pos) {
      const long s = s0 + s_sorted[pos];
      const long e = perm[s], n = send[s];
      float y[D_SH], cy[D_SH], hv[D_H], chv[D_H], rv[N_P], crv[N_P];
      load_spread(Y, e, y);
      load_spread(cY, e, cy);
      load_rows<D_H>(h, n, k, c, ok, hv);
      load_rows<D_H>(ch, n, k, c, ok, chv);
      load_rows<N_P>(R, e, k, c, ok, rv);
      load_rows<N_P>(cR, e, k, c, ok, crv);
      float msg[D_OUT];
      tp_dbl_messages(y, cy, hv, chv, rv, crv, msg);
#pragma unroll
      for (int m = 0; m < D_OUT; ++m) sum[m] += msg[m];
      const int next = pos + 1 < hi ? s_row[s_sorted[pos + 1]] : -1;
      if (next != cur) {  // the row's last slot in this segment
        if (s_start[cur] >= lo && s_start[cur + 1] <= hi) {
          write_row(cur, sum);
        } else {
          const int end = s_start[cur] < lo ? 0 : 1;  // cut at lo, or at hi
          float* dst = s_part + ((warp * 2 + end) * D_OUT) * 32 + lane;
#pragma unroll
          for (int m = 0; m < D_OUT; ++m) dst[m * 32] = sum[m];
          if (lane == 0) s_part_row[warp * 2 + end] = cur;
        }
#pragma unroll
        for (int m = 0; m < D_OUT; ++m) sum[m] = 0.f;
        cur = next;
      }
    }
  }
  __syncthreads();

  // fix-up: a cut row is summed by the warp whose segment it starts in,
  // then the following warps' partials, in warp order
  const int r = s_part_row[warp * 2 + 1];
  if (r >= 0) {
    float sum[D_OUT];
    const float* own = s_part + ((warp * 2 + 1) * D_OUT) * 32 + lane;
#pragma unroll
    for (int m = 0; m < D_OUT; ++m) sum[m] = own[m * 32];
    for (int w = warp + 1; w < SCT_WARPS && seg_lo(w, n_valid) < s_start[r + 1]; ++w) {
      if (s_part_row[w * 2] != r) continue;  // an empty segment
      const float* src = s_part + ((w * 2) * D_OUT) * 32 + lane;
#pragma unroll
      for (int m = 0; m < D_OUT; ++m) sum[m] += src[m * 32];
    }
    write_row(r, sum);
  }
}

// ---------------------------------------------------------------------------
// dY, dR, dh: per-slot gather of the receiver's cotangent row
// ---------------------------------------------------------------------------

template <int OUTS>
__global__ void __launch_bounds__(GTH_THREADS, 4) tp_dbl_gather_kernel(
    const float* __restrict__ G, const float* __restrict__ Y,
    const float* __restrict__ cY, const float* __restrict__ h,
    const float* __restrict__ ch, const float* __restrict__ R,
    const float* __restrict__ cR, const int* __restrict__ perm,
    const int* __restrict__ send, const int* __restrict__ local,
    const unsigned char* __restrict__ valid, const int* __restrict__ base,
    float* __restrict__ dY, float* __restrict__ dR, float* __restrict__ dh,
    long n_slots, int epb, int k) {
  constexpr int N_WARPS = GTH_THREADS / 32;
  constexpr bool WANT_Y = (OUTS & (OUT_DR | OUT_DH)) != 0;
  constexpr bool WANT_H = (OUTS & (OUT_DR | OUT_DY)) != 0;
  constexpr bool WANT_R = (OUTS & (OUT_DH | OUT_DY)) != 0;
  __shared__ float s_part[2][N_WARPS][D_SH];  // per-warp dY sums, two in flight
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int buf = 0;
  for (int i = 0; i < GTH_SLOTS; ++i) {
    const long s = static_cast<long>(blockIdx.x) * GTH_SLOTS + i;
    if (s >= n_slots) break;
    if (!valid[s]) {  // masked slot: dh's exact zeros, nothing else
      if constexpr ((OUTS & OUT_DH) != 0) {
        for (int c = tid; c < k; c += GTH_THREADS) {
#pragma unroll
          for (int m = 0; m < D_H; ++m) dh[(s * D_H + m) * k + c] = 0.f;
        }
      }
      continue;
    }
    const long e = perm[s], n = send[s];
    const long row = base[s / epb] + local[s];
    float mine = 0.f;  // lane m < D_SH: this warp's dY[m] over its channels
    for (int c0 = 0; c0 < k; c0 += GTH_THREADS) {  // one channel a thread
      const int c = c0 + tid;
      const bool ok = c < k;
      float g[D_OUT], y[D_SH], cy[D_SH], hv[D_H], chv[D_H], rv[N_P], crv[N_P];
      load_rows<D_OUT>(G, row, k, c, ok, g);
      if constexpr (WANT_Y) {
        load_spread(Y, e, y);
        load_spread(cY, e, cy);
      }
      if constexpr (WANT_H) {
        load_rows<D_H>(h, n, k, c, ok, hv);
        load_rows<D_H>(ch, n, k, c, ok, chv);
      }
      if constexpr (WANT_R) {
        load_rows<N_P>(R, e, k, c, ok, rv);
        load_rows<N_P>(cR, e, k, c, ok, crv);
      }
      if constexpr ((OUTS & OUT_DR) != 0) {
        float drv[N_P];
        tp_dbl_dr(y, cy, g, hv, chv, drv);
        if (ok) {
#pragma unroll
          for (int p = 0; p < N_P; ++p) dR[(e * N_P + p) * k + c] = drv[p];
        }
      }
      if constexpr ((OUTS & OUT_DH) != 0) {
        float dhv[D_H];
        tp_dbl_dh(y, cy, g, rv, crv, dhv);
        if (ok) {
#pragma unroll
          for (int m = 0; m < D_H; ++m) dh[(s * D_H + m) * k + c] = dhv[m];
        }
      }
      if constexpr ((OUTS & OUT_DY) != 0) {
        float dyv[D_SH];
        tp_dbl_dy(g, hv, chv, rv, crv, dyv);
#pragma unroll
        for (int m = 0; m < D_SH; ++m) {
          float v = dyv[m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
          if (lane == m) mine += v;
        }
      }
    }
    if constexpr ((OUTS & OUT_DY) != 0) {
      // over the warps in order
      if (lane < D_SH) s_part[buf][warp][lane] = mine;
      __syncthreads();
      if (tid < D_SH) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < N_WARPS; ++w) t += s_part[buf][w][tid];
        dY[e * D_SH + tid] = t;
      }
      buf ^= 1;  // the next valid slot writes the other half; this one is read
                 // before any thread passes that slot's barrier
    }
  }
}

// the gather's launches from PART on, in order, on one stream
template <int PART>
int launch_gather(unsigned blocks, const float* G, const float* Y, const float* cY,
                  const float* h, const float* ch, const float* R, const float* cR,
                  const int* perm, const int* send, const int* local,
                  const unsigned char* valid, const int* base, float* dY, float* dR,
                  float* dh, long n_slots, int epb, int k, cudaStream_t stream) {
  if constexpr (PART < GATHER_PARTS) {
    tp_dbl_gather_kernel<GATHER_OUTS[PART]><<<blocks, GTH_THREADS, 0, stream>>>(
        G, Y, cY, h, ch, R, cR, perm, send, local, valid, base, dY, dR, dh, n_slots,
        epb, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_gather<PART + 1>(blocks, G, Y, cY, h, ch, R, cR, perm, send, local,
                                   valid, base, dY, dR, dh, n_slots, epb, k, stream);
  }
  return 0;
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, and returns the
// cudaError_t of its launches; cudaErrorInvalidValue when the operands' sizes
// are not the ones this build's header was generated for (the wrapper
// checks them first).

extern "C" int tp_dbl_scatter(const float* Y, const float* cY, const float* h,
                              const float* ch, const float* R, const float* cR,
                              const int* perm, const int* send, const int* local,
                              const unsigned char* valid, float* out, int n_tiles,
                              int epb, int block_n, int d_sh, int d_h, int n_paths,
                              int d_out, int k, cudaStream_t stream) {
  if (d_sh != D_SH || d_h != D_H || n_paths != N_P || d_out != D_OUT ||
      epb < 1 || epb > MAX_EPB || block_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * SCT_WARPS * 2 * D_OUT * 32 +
      sizeof(int) * (2 * static_cast<size_t>(epb) + block_n + 1 + 2 * SCT_WARPS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tp_dbl_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_tiles, (k + 31) / 32);
  tp_dbl_scatter_kernel<<<grid, SCT_WARPS * 32, smem, stream>>>(
      Y, cY, h, ch, R, cR, perm, send, local, valid, out, epb, block_n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tp_dbl_gather(const float* G, const float* Y, const float* cY,
                             const float* h, const float* ch, const float* R,
                             const float* cR, const int* perm, const int* send,
                             const int* local, const unsigned char* valid,
                             const int* base, float* dY, float* dR, float* dh,
                             int n_tiles, int epb, int d_sh, int d_h, int n_paths,
                             int d_out, int k, cudaStream_t stream) {
  if (d_sh != D_SH || d_h != D_H || n_paths != N_P || d_out != D_OUT || epb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_slots = static_cast<long>(n_tiles) * epb;
  const long blocks = (n_slots + GTH_SLOTS - 1) / GTH_SLOTS;
  return launch_gather<0>(static_cast<unsigned>(blocks), G, Y, cY, h, ch, R, cR, perm,
                          send, local, valid, base, dY, dR, dh, n_slots, epb, k, stream);
}
