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
// Built once per (tensor-product spec, precision) with the header
// KERNEL_HEADER that repro_torch/kernels/channelwise_tp/kernel.py::
// spec_header generates: the operand precision PRECISION (round_op.cuh), the
// dimensions D_SH, D_H, N_P, D_OUT and the CG entries unrolled, grouped by
// one index, into straight-line scalar sums (tp_messages: msg[m3] by m3;
// tp_transpose: dh by m2, dR by path, per-channel dY by m1).  Every
// operand index is then a compile-time constant, so a thread keeps its
// slot's Y, h, R (and g) in registers and reads each from memory once, as
// the TPU kernels unroll the same tables at trace time.  Read from tables
// at run time, each entry would cost a warp one shared-memory read of the
// entry, one of Y and one or two of the operands for three flops; measured
// on the card, those reads and not the device memory set both kernels' time
// (PERF.md).
//
// Precision (the JAX package's pallas_bf16 / pallas_fp8 variants): a bf16 or
// fp8 build rounds every loaded Y, h and R element (and, in the backward,
// every loaded cotangent element) in registers (round_op.cuh; the forward
// after the next slot's loads are issued), and the forward rounds each
// slot's formed messages before they are added to their row's sums, as
// _tp_scatter_kernel rounds the messages before its scatter matmul; every
// sum stays fp32.  At a reduced precision
// the header forms the messages with __fmul_rn / __fadd_rn, in the plain
// version's order, so no multiply-add is fused: a message is then the plain
// version's bit for bit before it is rounded, and the kernel and its plain
// version round it to the same value.  The arrays stay fp32, so every build
// moves the same bytes.
//
// What bounds both on this card: bytes.  Each valid slot reads
// (d_h + n_paths) * k floats of h and R (14 * 128 * 4 = 7 KB at the paper's
// width, layer 1) for 3-4 flops per CG entry per channel (86 entries):
// about 6 flops per byte, below the fp32 ridge of 67e12 / 3.35e12 = 20.  The
// forward also writes every tile's [block_n, d_out, k] rows, padding tiles
// included; the backward writes dh and dR for every slot, masked ones too.
//
// Forward design: a gather per receiver row, balanced over the warps.
// Grid (tile, group of 32 channels), FWD_WARPS warps, a lane per channel.
// The block sorts the tile's valid slots by receiver row (a counting sort
// by ballots, slot order inside a row, in shared memory; rows without a
// slot are written as zeros on the way), and each warp sums an equal
// segment of the sorted slots: per slot it loads h and R (coalesced, the
// next slot's loads in flight while the current one is summed), spreads Y
// from one lane per component by shuffles, forms the d_out messages in
// registers and adds them to the current row's d_out sums.  A row that lies
// inside the segment is written at once; a row cut by a segment boundary
// (a hub's 128 slots span all segments) leaves its partial sums in shared
// memory, and the warp the row starts in adds them up in warp order and
// writes the row.  So every output element is written once, with no
// zeroing pass and no atomics, the time follows the tile's slot count and
// not its longest row, and a tile's slots need not be sorted.  A tile with
// no valid slot (the padding tiles, most of a serving bin's static tile
// count) writes its zeros and reads no h or R.
//
// Backward design: one thread per (slot, channel).  A block of BWD_THREADS
// threads owns BWD_SLOTS consecutive slots and walks the k channels in
// steps of BWD_THREADS.  Per valid slot a thread loads its channel of the
// receiver's cotangent row g (d_out), of h and of R, spreads Y by shuffles,
// and runs tp_transpose: three passes whose sums (dh by m2, dR by path, dY
// by m1) are registers, so every dh and dR element is written once, with no
// read-modify-write and no zeroing pass.  dY is summed over the channels by
// warp shuffles and then over the warps in order through shared memory.
// Masked slots write exact zeros and read nothing else.
//
// Determinism: no atomics anywhere; every sum runs in a fixed order (a
// row's slots in slot order, a cut row's partials in warp order, entries in
// the header's order inside their group, channels in a fixed tree), so two
// launches give bit-identical outputs.
// The plain versions sum in another order (each slot's entries, then the
// slots by index_add_), so the two agree to fp32 rounding: the stated
// tolerance is 2e-5 of the output's largest magnitude (chip_smoke.py).
//
// ptxas (sm_90a, -O3, CUDA 12.8) at the paper's two specs, as chip_smoke.py
// phase 1 prints and checks it: 0 bytes of stack frame, 0 bytes of spill
// stores and loads for both kernels; registers per thread, layer 0 / layer 1:
// tp_scatter_kernel 96 / 128 (the cap of __launch_bounds__(256, 2)),
// tp_gather_bwd_kernel 92 / 128 (the cap of __launch_bounds__(128, 4)); the
// bf16 and fp8 builds the same forward, and a backward of 88-90 / 112-114.
// Wider specs stay correct but may spill: at d_sh = d_out = 25 (l <= 4, the
// gpu test's widest case, whose forward needs more than 48 KB of dynamic
// shared memory) the forward has none, the backward 248 bytes of stack and
// 348 / 344 bytes of spill stores / loads.
#include <cuda_runtime.h>

#ifndef KERNEL_HEADER
#error "build with -DKERNEL_HEADER=<header from kernel.py::spec_header>"
#endif
#include KERNEL_HEADER
#include "round_op.cuh"

static_assert(D_SH <= 32 && D_H <= 32 && D_OUT <= 32,
              "a slot's Y is spread from one lane per component");

namespace {

constexpr int FWD_WARPS = 8;      // segments of a tile summed at once
constexpr int BWD_THREADS = 128;  // channels of a slot summed at once
constexpr int BWD_SLOTS = 4;      // slots of one backward block
constexpr int MAX_EPB = 1024;     // slots of a tile the forward can sort
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load_slot(const float* __restrict__ Y,
                                          const float* __restrict__ h,
                                          const float* __restrict__ R, long s,
                                          int k, int c, bool ok, float& yl,
                                          float (&hv)[D_H], float (&rv)[N_P]) {
  const int lane = threadIdx.x & 31;
  yl = lane < D_SH ? __ldg(Y + s * D_SH + lane) : 0.f;
#pragma unroll
  for (int m = 0; m < D_H; ++m)
    hv[m] = ok ? __ldg(h + (s * D_H + m) * k + c) : 0.f;
#pragma unroll
  for (int p = 0; p < N_P; ++p)
    rv[p] = ok ? __ldg(R + (s * N_P + p) * k + c) : 0.f;
}

__device__ __forceinline__ void spread_y(float yl, float (&y)[D_SH]) {
#pragma unroll
  for (int m = 0; m < D_SH; ++m) y[m] = __shfl_sync(FULL, yl, m);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__device__ __forceinline__ int seg_lo(int w, int n_valid) {
  return static_cast<int>((static_cast<long>(w) * n_valid) / FWD_WARPS);
}

__global__ void __launch_bounds__(FWD_WARPS * 32, 2) tp_scatter_kernel(
    const float* __restrict__ Y, const float* __restrict__ h,
    const float* __restrict__ R, const int* __restrict__ local,
    const unsigned char* __restrict__ valid, float* __restrict__ out, int epb,
    int block_n, int k) {
  extern __shared__ float smem_f[];
  float* s_part = smem_f;              // [FWD_WARPS][2][D_OUT][32] cut rows
  int* s_row = reinterpret_cast<int*>(s_part + FWD_WARPS * 2 * D_OUT * 32);
  int* s_sorted = s_row + epb;         // [epb] valid slots by (row, slot)
  int* s_start = s_sorted + epb;       // [block_n + 1] first position of a row
  int* s_part_row = s_start + block_n + 1;  // [FWD_WARPS][2] row of a partial
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

  for (int j = tid; j < epb; j += FWD_WARPS * 32)
    s_row[j] = valid[s0 + j] ? local[s0 + j] : -1;
  __syncthreads();

  // counting sort of the valid slots by row, slot order inside a row; rows
  // without a slot are written as zeros on the way
  for (int r = warp; r < block_n; r += FWD_WARPS) {
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
  if (n_valid == 0) return;  // a padding tile: zeros written, no h or R read
  for (int r = warp; r < block_n; r += FWD_WARPS) {
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
    float yl, hv[D_H], rv[N_P];
    load_slot(Y, h, R, s0 + s_sorted[lo], k, c, ok, yl, hv, rv);
    int cur = s_row[s_sorted[lo]];
    for (int pos = lo; pos < hi; ++pos) {
      float y[D_SH], hc[D_H], rc[N_P];
      spread_y(round_op(yl), y);
#pragma unroll
      for (int m = 0; m < D_H; ++m) hc[m] = hv[m];
#pragma unroll
      for (int p = 0; p < N_P; ++p) rc[p] = rv[p];
      if (pos + 1 < hi) load_slot(Y, h, R, s0 + s_sorted[pos + 1], k, c, ok, yl, hv, rv);
      // rounded here, not as loaded: the next slot's loads stay in flight
      round_all(hc);
      round_all(rc);
      float msg[D_OUT];
      tp_messages(y, hc, rc, msg);
      round_all(msg);
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

  // fix-up: a cut row is summed by the warp whose segment it starts in (it
  // left the row's first partial at its hi end), then the following
  // warps' partials (each at its lo end), in warp order
  const int r = s_part_row[warp * 2 + 1];
  if (r >= 0) {
    float sum[D_OUT];
    const float* own = s_part + ((warp * 2 + 1) * D_OUT) * 32 + lane;
#pragma unroll
    for (int m = 0; m < D_OUT; ++m) sum[m] = own[m * 32];
    for (int w = warp + 1; w < FWD_WARPS && seg_lo(w, n_valid) < s_start[r + 1]; ++w) {
      if (s_part_row[w * 2] != r) continue;  // an empty segment
      const float* src = s_part + ((w * 2) * D_OUT) * 32 + lane;
#pragma unroll
      for (int m = 0; m < D_OUT; ++m) sum[m] += src[m * 32];
    }
    write_row(r, sum);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BWD_THREADS, 4) tp_gather_bwd_kernel(
    const float* __restrict__ G, const float* __restrict__ Y,
    const float* __restrict__ h, const float* __restrict__ R,
    const int* __restrict__ local, const unsigned char* __restrict__ valid,
    float* __restrict__ dY, float* __restrict__ dh, float* __restrict__ dR,
    long n_slots, int epb, int block_n, int k) {
  constexpr int N_WARPS = BWD_THREADS / 32;
  __shared__ float s_part[2][N_WARPS][D_SH];  // per-warp dY sums, two in flight
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int buf = 0;
  for (int i = 0; i < BWD_SLOTS; ++i) {
    const long s = static_cast<long>(blockIdx.x) * BWD_SLOTS + i;
    if (s >= n_slots) break;
    if (!valid[s]) {  // masked slot: exact zeros
      for (int c = tid; c < k; c += BWD_THREADS) {
#pragma unroll
        for (int m = 0; m < D_H; ++m) dh[(s * D_H + m) * k + c] = 0.f;
#pragma unroll
        for (int p = 0; p < N_P; ++p) dR[(s * N_P + p) * k + c] = 0.f;
      }
      if (tid < D_SH) dY[s * D_SH + tid] = 0.f;
      continue;
    }
    const long row = (s / epb) * block_n + local[s];
    float dy_sum[D_SH];
#pragma unroll
    for (int m = 0; m < D_SH; ++m) dy_sum[m] = 0.f;
    for (int c0 = 0; c0 < k; c0 += BWD_THREADS) {  // one channel a thread
      const int c = c0 + tid;
      const bool ok = c < k;
      float g[D_OUT], hv[D_H], rv[N_P], yl, y[D_SH];
#pragma unroll
      for (int m = 0; m < D_OUT; ++m)
        g[m] = ok ? __ldg(G + (row * D_OUT + m) * k + c) : 0.f;
      load_slot(Y, h, R, s, k, c, ok, yl, hv, rv);
      round_all(g);
      round_all(hv);
      round_all(rv);
      spread_y(round_op(yl), y);
      float dhv[D_H], drv[N_P], dyv[D_SH];
      tp_transpose(y, g, hv, rv, dhv, drv, dyv);
      if (ok) {
#pragma unroll
        for (int m = 0; m < D_H; ++m) dh[(s * D_H + m) * k + c] = dhv[m];
#pragma unroll
        for (int p = 0; p < N_P; ++p) dR[(s * N_P + p) * k + c] = drv[p];
      }
#pragma unroll
      for (int m = 0; m < D_SH; ++m) dy_sum[m] += dyv[m];
    }
    // dY: over the warp's channels by shuffles, then over the warps in order
#pragma unroll
    for (int m = 0; m < D_SH; ++m) {
      float v = dy_sum[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      if (lane == 0) s_part[buf][warp][m] = v;
    }
    __syncthreads();
    if (tid < D_SH) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < N_WARPS; ++w) t += s_part[buf][w][tid];
      dY[s * D_SH + tid] = t;
    }
    buf ^= 1;  // the next valid slot writes the other half; this one is read
               // before any thread passes that slot's barrier
  }
}

}  // namespace

// Each entry point launches on `stream`, allocates nothing, and returns the
// cudaError_t of the launch; cudaErrorInvalidValue when the operands' sizes
// are not the ones this build's header was generated for (the wrapper
// checks them first).

extern "C" int tp_scatter_fwd(const float* Y, const float* h, const float* R,
                              const int* local, const unsigned char* valid,
                              float* out, int n_tiles, int epb, int block_n,
                              int d_sh, int d_h, int n_paths, int d_out, int k,
                              cudaStream_t stream) {
  if (d_sh != D_SH || d_h != D_H || n_paths != N_P || d_out != D_OUT ||
      epb < 1 || epb > MAX_EPB || block_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * FWD_WARPS * 2 * D_OUT * 32 +
      sizeof(int) * (2 * static_cast<size_t>(epb) + block_n + 1 + 2 * FWD_WARPS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tp_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_tiles, (k + 31) / 32);
  tp_scatter_kernel<<<grid, FWD_WARPS * 32, smem, stream>>>(
      Y, h, R, local, valid, out, epb, block_n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tp_gather_bwd(const float* G, const float* Y, const float* h,
                             const float* R, const int* local,
                             const unsigned char* valid, float* dY, float* dh,
                             float* dR, int n_tiles, int epb, int block_n,
                             int d_sh, int d_h, int n_paths, int d_out, int k,
                             cudaStream_t stream) {
  if (d_sh != D_SH || d_h != D_H || n_paths != N_P || d_out != D_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_slots = static_cast<long>(n_tiles) * epb;
  const long blocks = (n_slots + BWD_SLOTS - 1) / BWD_SLOTS;
  tp_gather_bwd_kernel<<<static_cast<unsigned>(blocks), BWD_THREADS, 0, stream>>>(
      G, Y, h, R, local, valid, dY, dh, dR, n_slots, epb, block_n, k);
  return static_cast<int>(cudaGetLastError());
}
