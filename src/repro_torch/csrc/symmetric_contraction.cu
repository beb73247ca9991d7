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
// Built once per (symmetric-contraction spec, precision) with the header
// KERNEL_HEADER that repro_torch/kernels/symmetric_contraction/kernel.py::
// spec_header generates: the operand precision PRECISION (round_op.cuh), the
// dimensions D_IN, P_TOTAL, D_OUT and the CG groups (one per
// (term, eta, M), in table order) unrolled into the cases of a switch inside
// a loop that is not unrolled: symcon_forward (per group s = sum of val *
// prod A[m_x], then b[M] += w[eta] * s) and symcon_backward (per group the
// same s, the product-rule terms of dA entry by entry, dw[eta] = / += g[M] *
// s).  Every operand and output index is a compile-time constant, so the
// running sums and a thread's B (g and dA) columns are registers, as the TPU
// kernels unroll the same groups at trace time.
//
// Precision (the JAX package's pallas_bf16 / pallas_fp8 variants): a bf16 or
// fp8 build rounds every loaded A, W and G element (round_op in the load the
// header's functions are given) and computes in fp32 as the fp32 build
// does.  The arrays stay fp32, so every build moves the same bytes.
//
// What bounds both on this card: bytes.  Per (atom, channel) the forward
// reads d_in + p_total floats and writes d_out (16 + 9 in, 4 out at the
// paper's width: 116 bytes) for about 3 flops per CG entry (90 entries),
// some 2.5 flops per byte; the backward reads 29 floats and writes 25 (216
// bytes) for about 8 flops per entry.  Both sit below the H100's fp32 ridge
// of 67e12 / 3.35e12 = 20 flops per byte, so the only gain is to move each
// byte once and keep enough loads in flight.  The weights differ per
// (atom, channel), so no operand is reused across lanes: this is no matrix
// product, and neither tensor cores nor TMA have work to do here.
//
// Design: one thread per (atom n, channel c), a flat bounds-checked grid
// over N * k with channels on the lanes, so every row of every operand is
// read and written by a warp as one coalesced 128-byte line.  Consecutive
// groups share a case up to 192 CG entries (the paper's spec, 90 entries, is
// one case of straight-line code that loads its rows of A and W before any
// arithmetic, 40 and 64 registers), and a larger group is cut into cases;
// each case loads the rows of A it uses, from L1 after the first case, and
// a weight row where its run of groups starts.  A thread writes each element of B (of dA and dW)
// exactly once: no zeroing pass, no read-modify-write of device memory, no
// run-time table, no atomics.  Straight-line code over correlation 3's
// entries spilled (592 and 408 bytes a thread at MACE-MP-0 medium's 2,396
// entries, 2.7-2.8 KB at large's 7,101), because the compilers keep
// products of A shared by entries far apart live in between; the loop keeps
// no product across cases.  Every sum runs in the header's fixed order
// (entries in table order inside a group, groups in table order), so two
// launches give bit-identical outputs; the plain versions sum in the same
// order but may round differently where the compiler fuses a multiply and
// an add, so the stated tolerance is 2e-5 of the output's largest
// magnitude (chip_smoke.py).
//
// ptxas (sm_90a, -O3): chip_smoke.py phase 1 prints the report and requires
// 0 bytes of stack frame and 0 bytes of spills for both kernels at the
// paper's spec and at both MACE-MP-0 specs.
#include <cuda_runtime.h>

#ifndef KERNEL_HEADER
#error "build with -DKERNEL_HEADER=<header from kernel.py::spec_header>"
#endif
#include KERNEL_HEADER
#include "round_op.cuh"

namespace {

// threads per block: 64, 128 and 256 agree within 6% at 256 and 3,072
// atoms on an NVIDIA H100 80GB HBM3 at 700 W, none first in every run
// (PERF.md, Findings)
constexpr int THREADS = 128;

// the load of one operand the header's functions make: rounded to the
// build's precision
struct RoundedLoad {
  __device__ __forceinline__ float operator()(const float* __restrict__ p) const {
    return round_op(__ldg(p));
  }
};

__global__ void __launch_bounds__(THREADS) symcon_fwd_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    float* __restrict__ B, int N, int k) {
  const long t = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long>(N) * k) return;
  const long n = t / k;
  const long c = t - n * k;
  symcon_forward(A + n * D_IN * k + c, W + n * P_TOTAL * k + c,
                 B + n * D_OUT * k + c, k, RoundedLoad());
}

__global__ void __launch_bounds__(THREADS) symcon_bwd_kernel(
    const float* __restrict__ A, const float* __restrict__ W,
    const float* __restrict__ G, float* __restrict__ dA,
    float* __restrict__ dW, int N, int k) {
  const long t = static_cast<long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= static_cast<long>(N) * k) return;
  const long n = t / k;
  const long c = t - n * k;
  symcon_backward(A + n * D_IN * k + c, W + n * P_TOTAL * k + c,
                  G + n * D_OUT * k + c, dA + n * D_IN * k + c,
                  dW + n * P_TOTAL * k + c, k, RoundedLoad());
}

// round_op on n values: the rounding of this build, checked against the
// plain round_to on the card (chip_smoke.py)
__global__ void __launch_bounds__(THREADS) round_values_kernel(
    const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) y[i] = round_op(x[i]);
}

}  // namespace

// ---- host launchers

namespace {

unsigned blocks_for(int N, int k) {
  const long total = static_cast<long>(N) * k;
  return static_cast<unsigned>((total + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int symcon_fwd(const float* A, const float* W, float* B, int N,
                          int k, cudaStream_t stream) {
  symcon_fwd_kernel<<<blocks_for(N, k), THREADS, 0, stream>>>(A, W, B, N, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int symcon_bwd(const float* A, const float* W, const float* G,
                          float* dA, float* dW, int N, int k,
                          cudaStream_t stream) {
  symcon_bwd_kernel<<<blocks_for(N, k), THREADS, 0, stream>>>(A, W, G, dA, dW,
                                                              N, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int round_values(const float* x, float* y, int n,
                            cudaStream_t stream) {
  round_values_kernel<<<blocks_for(n, 1), THREADS, 0, stream>>>(x, y, n);
  return static_cast<int>(cudaGetLastError());
}
