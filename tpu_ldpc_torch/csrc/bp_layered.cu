// Layered BP decoder (normalized / offset min-sum, exact sum-product,
// sumproduct-fast, and fixed-point quantized min-sum) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel`, layered branch (one_iter, pallas_bp.py:608-634, with latch and
// syndrome_violations), its CN updates _cn_minsum_kernel (219-233),
// _cn_sumproduct_kernel / _phi (236-238, 306-321) and
// _cn_sumproduct_fast_kernel / _ctilde_k / _fpair_k (241-303), and its
// quantized mode (qz / sat_msg / sat_post, 459-473, applied at 617-628 and
// 885-887).  What it computes is golden's row-layered schedule
// (golden/decoder.py:409-423):
//
//   for each block-row i in ascending order, for each of its Z checks r:
//     q_e   = P[col_e*Z + (r+s_e) mod Z] - R[e*Z + r]    (edge order)
//     r_e   = quantize(CN update of the row's sat(q))    (bp_common.cuh)
//     P[..] = sat_post(q_e + r_e);  R[e*Z + r] = r_e
//
// The quantization policy (NoQuant: identities; Quant: golden's grid)
// saturates only the CN's input: the posterior update uses the
// unsaturated q_e, then the APP saturation (the wide-APP datapath).  The
// LLRs are quantized as they load.
//
// Design:
//   * One thread block per codeword; grid = batch.  P[n] and R[E*Z] stay
//     in dynamic shared memory for all iterations, (n + E*Z)*4 bytes
//     (17,152 B for the judged code).  There is no L array: the layered
//     update never reads the channel LLRs again.
//   * Block-rows run strictly one after another, with a __syncthreads()
//     between rows.  Inside a block-row one thread takes one check r.  The
//     Z checks of a block-row touch disjoint variables (each circulant is
//     a permutation and each block-column appears once per row), so
//     running them in parallel is exact: it equals golden's
//     check-by-check loop.
//   * Each thread runs the two-pass row scan of the flooding kernel: pass 1
//     feeds q to the CN update, pass 2 recomputes q from the same operands
//     (P[v] is written only by this thread, after it is read), so no
//     per-row array is kept.
//   * Early termination with golden semantics: a standalone syndrome
//     before the first sweep (iters_used 0), and one after each sweep
//     `it`, whose __syncthreads_or verdict latches iters_used = it and
//     ends the block.  With ET off one syndrome after the last sweep
//     gives ok.  (The flooding kernel's check fused into the CN pass sees
//     the posterior of it-1; here the posterior changes row by row, so
//     the check is its own pass.)
//   * Built with -fmad=false; min-sum is bit-exact with the plain version,
//     sum-product agrees frame by frame (tanhf / logf round differently
//     from PyTorch's CPU functions).
//
// What bounds it on the card: the serial chain of block-rows.  Only Z
// threads are busy in each row (64 of each judged-code block), and each
// row is a dependent step of E/mb edges' worth of shared-memory gathers
// (plus four transcendentals per edge for sum-product).  This first design
// accepts the under-use; several codewords per block (to fill the warps)
// is later work.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kMaxThreads = 256;

template <class CN, class QP>
__global__ void __launch_bounds__(kMaxThreads)
bp_layered_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                  uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                  const int32_t* __restrict__ edge_col,
                  const int32_t* __restrict__ edge_shift,
                  const int32_t* __restrict__ row_ptr, int Z, int mb, int nb,
                  int E, int iters, CN proto, QP quant, int early_stop) {
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* P = smem;
  float* R = P + n;  // E * Z messages, check coordinates
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    P[v] = quant.quantize(llr_b[v]);
  }
  for (int t = threadIdx.x; t < E * Z; t += blockDim.x) R[t] = 0.0f;
  __syncthreads();

  // block-uniform: every change comes from a __syncthreads_or verdict
  bool converged = false;
  int iters_used = iters;
  if (early_stop && !__syncthreads_or(count_violations(
                        P, edge_col, edge_shift, row_ptr, Z, m))) {
    converged = true;
    iters_used = 0;
  }
  for (int it = 1; !converged && it <= iters; ++it) {
    for (int i = 0; i < mb; ++i) {
      const int e0 = row_ptr[i];
      const int e1 = row_ptr[i + 1];
      for (int r = threadIdx.x; r < Z; r += blockDim.x) {
        CN cn = proto;
        cn.begin();
        for (int e = e0; e < e1; ++e) {
          const int v = edge_col[e] * Z + wrap_add(r, edge_shift[e], Z);
          cn.add(e - e0, quant.sat(P[v] - R[e * Z + r]));
        }
        cn.finish(e1 - e0);
        for (int e = e0; e < e1; ++e) {
          const int v = edge_col[e] * Z + wrap_add(r, edge_shift[e], Z);
          const float q = P[v] - R[e * Z + r];
          const float r_new = quant.quantize(cn.out(e - e0, quant.sat(q)));
          P[v] = quant.sat_post(q + r_new);
          R[e * Z + r] = r_new;
        }
      }
      __syncthreads();
    }
    if (early_stop && !__syncthreads_or(count_violations(
                          P, edge_col, edge_shift, row_ptr, Z, m))) {
      converged = true;
      iters_used = it;
    }
  }

  int ok;
  if (converged) {
    ok = 1;
  } else if (early_stop) {
    ok = 0;  // the check after the last sweep already failed
  } else {
    ok = !__syncthreads_or(
        count_violations(P, edge_col, edge_shift, row_ptr, Z, m));
  }
  uint8_t* bits_b = bits + b * n;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    bits_b[v] = P[v] < 0.0f;
  }
  if (threadIdx.x == 0) {
    ok_out[b] = (uint8_t)ok;
    iu_out[b] = iters_used;
  }
}

template <class CN, class QP>
cudaError_t launch(const float* llr, uint8_t* bits, uint8_t* ok,
                   int32_t* iters_used, const int32_t* edge_col,
                   const int32_t* edge_shift, const int32_t* row_ptr,
                   int batch, int Z, int mb, int nb, int E, int iters,
                   float alpha, float beta, QP quant, int early_stop,
                   int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bp_layered_kernel<CN, QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = alpha;
  proto.beta = beta;
  bp_layered_kernel<CN, QP><<<batch, threads, smem, stream>>>(
      llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr, Z, mb, nb,
      E, iters, proto, quant, early_stop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t ldpc_bp_layered_smem_bytes(int Z, int nb, int E) {
  return ((size_t)nb * Z + (size_t)E * Z) * sizeof(float);
}

// Threads of one block: one per check of a block-row, in whole warps.
int ldpc_bp_layered_threads(int Z) {
  const int t = (Z + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast (ldpc::Algo).
// quantized != 0 selects fixed-point min-sum on the grid `step` (a power
// of two) with largest index `kmax` and saturation limits `lim_msg` /
// `lim_post`; with any other algo it returns cudaErrorInvalidValue.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_layered(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                    int32_t* iters_used, const int32_t* edge_col,
                    const int32_t* edge_shift, const int32_t* row_ptr,
                    int batch, int Z, int mb, int nb, int E, int iters,
                    float alpha, float beta, int early_stop, int quantized,
                    float step, float kmax, float lim_msg, float lim_post,
                    void* stream) {
  const size_t smem = ldpc_bp_layered_smem_bytes(Z, nb, E);
  const int threads = ldpc_bp_layered_threads(Z);
  const cudaStream_t s = (cudaStream_t)stream;
#define LDPC_LAUNCH(CN, QUANT)                                             \
  launch<CN>(llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr,    \
             batch, Z, mb, nb, E, iters, alpha, beta, QUANT, early_stop,  \
             threads, smem, s)
  if (quantized) {
    if (algo != kMinSum) return (int)cudaErrorInvalidValue;
    return (int)LDPC_LAUNCH(MinSum, (Quant{step, kmax, lim_msg, lim_post}));
  }
  if (algo == kMinSum) return (int)LDPC_LAUNCH(MinSum, NoQuant{});
  if (algo == kSumProduct) return (int)LDPC_LAUNCH(SumProduct, NoQuant{});
  if (algo == kSumProductFast) {
    return (int)LDPC_LAUNCH(SumProductFast, NoQuant{});
  }
#undef LDPC_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
