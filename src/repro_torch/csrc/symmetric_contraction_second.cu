// Second order of the symmetric contraction (paper Algorithm 3): the VJP of
// the backward kernel's map (A, W, G) -> (dA, dW), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes this derivative of its
// backward kernel (src/repro/kernels/symmetric_contraction/ops.py::
// _symcon_bwd_op) by autodiff of a pure-XLA twin, which XLA fuses under jit.
// Training needs it at every step, since forces in the loss make each step a
// grad-of-grad; eager autograd over the same unrolled table launched one op
// per CG entry and factor, some 135,000 a call at correlation 3.
//
// Layout (k minor, as csrc/symmetric_contraction.cu):
//   A, U      [N, d_in,    k]   atomic basis; cotangent of dA
//   W, V      [N, p_total, k]   gathered weights; cotangent of dW
//   G         [N, d_out,   k]   cotangent of the forward's output
//   dA, dW, dG                  shapes of A, W, G
//
// Built once per symmetric-contraction spec with the fp32 header of
// repro_torch/kernels/symmetric_contraction/kernel.py::spec_header, whose
// symcon_second holds the CG groups as scalar statements: per group
// j (weight row eta, output row M) s_j and its derivative along U, ds_j;
// dG[M] += W[eta] ds_j + V[eta] s_j, dW[eta] += G[M] ds_j, and per entry and
// factor the product-rule terms of dA.  The second order is fp32 whatever
// the precision of the first order.
//
// What bounds it on this card: operations at correlation 3, bytes below.
// Per (atom, channel) it reads 2 (d_in + p_total) + d_out floats and writes
// d_in + p_total + d_out (572 bytes at correlation 3, 16 + 29 + 4 rows),
// and does 37 flops for each of the 2,306 third-order entries: some 150
// flops per byte, far above the H100's fp32 ridge of 20.  At correlation 2
// (90 entries) it is some 5 flops per byte, below the ridge.
//
// Design: as the first-order kernels, one thread per (atom n, channel c),
// channels on the lanes, each row read and written by a warp as coalesced
// lines; no shared memory, no run-time table, no atomics.  Unlike them it
// does not hold the whole group sweep as one straight-line block: at
// correlation 3 that spilled 5 KB a thread, because the compilers keep
// products of A that entries far apart share live in between.  The header
// cuts the entries into the cases of a switch inside a loop that is not
// unrolled (at most 96 entries a case), and each case loads the rows of A and
// U it uses, from L1 after the first case, so no product is kept across
// cases or hoisted out of the loop.  G, the dA and dG sums, the running
// group sums and the current weight row's W, V and dW sum stay in registers.
// A spec with more output rows than a launch keeps live runs in
// SECOND_ORDER_PARTS launches, one per run of output irreps, each an
// instance symcon_dbl_kernel<PART> of its own registers (MACE-MP-0 large:
// rows 0-3, then the five rows of l = 2; its 9 rows in one launch spilled
// 48 bytes a thread, and both parts in one function 144); each keeps its
// rows of G and dG live, and a later part starts dA's sums from the ones
// the part before stored.  Every sum runs in the header's fixed order (groups,
// entries, factors), across the parts as in one, so two calls give
// bit-identical outputs.  ptxas must report 0 bytes of stack frame and of
// spills (chip_smoke.py).
#include <cuda_runtime.h>

#ifndef KERNEL_HEADER
#error "build with -DKERNEL_HEADER=<header from kernel.py::spec_header>"
#endif
#include KERNEL_HEADER

namespace {

constexpr int THREADS = 128;

template <int PART>
__global__ void __launch_bounds__(THREADS) symcon_dbl_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ G, const float* __restrict__ U,
    const float* __restrict__ V, float* __restrict__ dA,
    float* __restrict__ dW, float* __restrict__ dG, int N, int k) {
  const long t = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long>(N) * k) return;
  const long n = t / k;
  const long c = t - n * k;
  const long in = n * D_IN * k + c, w = n * P_TOTAL * k + c, out = n * D_OUT * k + c;
  symcon_second<PART>(A + in, W + w, G + out, U + in, V + w, dA + in, dW + w, dG + out,
                      k);
}

}  // namespace

// ---- host launchers

namespace {

// the parts from PART on, in order, on one stream
template <int PART>
int launch_parts(unsigned blocks, const float* A, const float* W, const float* G,
                 const float* U, const float* V, float* dA, float* dW, float* dG, int N,
                 int k, cudaStream_t stream) {
  if constexpr (PART < SECOND_ORDER_PARTS) {
    symcon_dbl_kernel<PART><<<blocks, THREADS, 0, stream>>>(A, W, G, U, V, dA, dW, dG, N, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_parts<PART + 1>(blocks, A, W, G, U, V, dA, dW, dG, N, k, stream);
  }
  return 0;
}

}  // namespace

extern "C" int symcon_dbl(const float* A, const float* W, const float* G,
                          const float* U, const float* V, float* dA, float* dW,
                          float* dG, int N, int k, cudaStream_t stream) {
  const long total = static_cast<long>(N) * k;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  return launch_parts<0>(blocks, A, W, G, U, V, dA, dW, dG, N, k, stream);
}
