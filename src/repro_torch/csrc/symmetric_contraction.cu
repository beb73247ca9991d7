// Symmetric tensor contraction (paper Algorithm 3), forward and backward,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   forward  src/repro/kernels/symmetric_contraction/kernel.py::_symcon_kernel
//   backward src/repro/kernels/symmetric_contraction/kernel.py::_symcon_bwd_kernel
//
// Layout (k minor, as in the TPU kernels):
//   A  [N, d_in,    k]   atomic basis
//   W  [N, p_total, k]   species-gathered weights, (L, nu) terms concatenated
//   B  [N, d_out,   k]   output;  G = dL/dB has B's shape
//   dA, dW               shapes of A, W
//
// CG tables, read at run time (built once per spec and cached per device by
// repro_torch/kernels/symmetric_contraction/kernel.py::device_tables):
//   groups  [n_groups, 5] int32  (w_idx, out_idx, nu, first entry, end entry)
//   ent_idx [n_ent, 3]    int32  A rows m_0..m_{nu-1} of each entry
//   ent_val [n_ent]       float  U value of each entry
// One group is one (term, eta, M) of _group_entries; groups sharing a weight
// row eta accumulate into it.
//
// What bounds it on this card: bytes.  Per (atom, channel) the forward reads
// d_in + p_total floats and writes d_out (16 + 9 in, 4 out at the paper's
// width: 116 bytes) and does about 3 flops per CG entry (90 entries), some
// 2.5 flops per byte, below the H100's fp32 ridge of 67e12 / 3.35e12 = 20
// flops per byte.  At serving sizes (N = 256 atoms) the whole call moves
// about 4 MB, so launch latency is as large as the bound.
//
// Design: one thread per (atom n, channel c).  Neighbouring threads take
// neighbouring channels, so every load and store of a row is coalesced.
// Each thread owns its whole (n, :, c) column of every output, so no two
// threads write one address: no atomics, and the order of every sum is the
// TPU kernel's (entries in table order, groups in table order).  The A
// column is held in a per-thread array; the backward's dA column too, and
// it is written once at the end.  The table reads are the same address for
// every thread of a warp (a broadcast).  Making it fast (templated unrolling
// per spec, several channels per thread, shared-memory staging) is later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_D_IN = 32;  // the wrapper refuses d_in above this

__global__ void symcon_fwd_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    float* __restrict__ B, const int* __restrict__ groups,
    const int* __restrict__ ent_idx, const float* __restrict__ ent_val,
    int n_groups, int N, int d_in, int p_total, int d_out, int k) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(N) * k) return;
  const long n = t / k;
  const int c = static_cast<int>(t % k);
  const float* a_col = A + n * d_in * k + c;
  const float* w_col = W + n * p_total * k + c;
  float* b_col = B + n * d_out * k + c;

  float a[MAX_D_IN];
  for (int m = 0; m < d_in; ++m) a[m] = a_col[static_cast<long>(m) * k];
  for (int m = 0; m < d_out; ++m) b_col[static_cast<long>(m) * k] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    const int* gr = groups + 5 * g;
    const int w_idx = gr[0], out_idx = gr[1], nu = gr[2];
    float s = 0.f;
    for (int e = gr[3]; e < gr[4]; ++e) {
      const int* ix = ent_idx + 3 * e;
      float p = a[ix[0]];
      for (int x = 1; x < nu; ++x) p *= a[ix[x]];
      s += p * ent_val[e];
    }
    b_col[static_cast<long>(out_idx) * k] += w_col[static_cast<long>(w_idx) * k] * s;
  }
}

__global__ void symcon_bwd_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ G, float* __restrict__ dA,
    float* __restrict__ dW, const int* __restrict__ groups,
    const int* __restrict__ ent_idx, const float* __restrict__ ent_val,
    int n_groups, int N, int d_in, int p_total, int d_out, int k) {
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(N) * k) return;
  const long n = t / k;
  const int c = static_cast<int>(t % k);
  const float* a_col = A + n * d_in * k + c;
  const float* w_col = W + n * p_total * k + c;
  const float* g_col = G + n * d_out * k + c;
  float* dw_col = dW + n * p_total * k + c;

  float a[MAX_D_IN];
  float da[MAX_D_IN];
  for (int m = 0; m < d_in; ++m) {
    a[m] = a_col[static_cast<long>(m) * k];
    da[m] = 0.f;
  }
  for (int p = 0; p < p_total; ++p) dw_col[static_cast<long>(p) * k] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    const int* gr = groups + 5 * g;
    const int w_idx = gr[0], out_idx = gr[1], nu = gr[2];
    const float gv = g_col[static_cast<long>(out_idx) * k];
    const float gw = gv * w_col[static_cast<long>(w_idx) * k];
    float s = 0.f;
    for (int e = gr[3]; e < gr[4]; ++e) {
      const int* ix = ent_idx + 3 * e;
      const float val = ent_val[e];
      // forward product, re-derived from A -> dW
      float prod = a[ix[0]];
      for (int x = 1; x < nu; ++x) prod *= a[ix[x]];
      s += prod * val;
      // product rule -> dA: drop factor x, keep the other nu - 1
      for (int x = 0; x < nu; ++x) {
        float p = 1.f;
        for (int y = 0; y < nu; ++y) {
          if (y != x) p *= a[ix[y]];
        }
        da[ix[x]] += gw * (p * val);
      }
    }
    // groups sharing eta hit the same weight row: accumulate
    dw_col[static_cast<long>(w_idx) * k] += gv * s;
  }
  float* da_col = dA + n * d_in * k + c;
  for (int m = 0; m < d_in; ++m) da_col[static_cast<long>(m) * k] = da[m];
}

constexpr int THREADS = 128;

int blocks_for(int N, int k) {
  const long total = static_cast<long>(N) * k;
  return static_cast<int>((total + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int symcon_fwd(const float* A, const float* W, float* B,
                          const int* groups, const int* ent_idx,
                          const float* ent_val, int n_groups, int N, int d_in,
                          int p_total, int d_out, int k, cudaStream_t stream) {
  symcon_fwd_kernel<<<blocks_for(N, k), THREADS, 0, stream>>>(
      A, W, B, groups, ent_idx, ent_val, n_groups, N, d_in, p_total, d_out, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int symcon_bwd(const float* A, const float* W, const float* G,
                          float* dA, float* dW, const int* groups,
                          const int* ent_idx, const float* ent_val,
                          int n_groups, int N, int d_in, int p_total,
                          int d_out, int k, cudaStream_t stream) {
  symcon_bwd_kernel<<<blocks_for(N, k), THREADS, 0, stream>>>(
      A, W, G, dA, dW, groups, ent_idx, ent_val, n_groups, N, d_in, p_total,
      d_out, k);
  return static_cast<int>(cudaGetLastError());
}
