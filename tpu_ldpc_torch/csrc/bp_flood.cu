// Flooding BP decoder (normalized / offset min-sum, exact sum-product,
// sumproduct-fast, and fixed-point quantized min-sum) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel`, flooding branch (cn_pass_fused, vn_pass, latch,
// syndrome_violations and the final check, pallas_bp.py:514-707) with its
// CN updates _cn_minsum_kernel (219-233), _cn_sumproduct_kernel / _phi
// (236-238, 306-321) and _cn_sumproduct_fast_kernel / _ctilde_k /
// _fpair_k (241-303), and its quantized mode (qz / sat_msg / sat_post,
// 459-473, applied at 557-561, 583 and 885-887).  It ports WHAT that
// kernel computes, not its TPU layout (codewords on lanes, Z on
// sublanes, static rolls):
//
//   * One thread block per codeword; grid = batch.  Nothing is padded, so
//     no padding can leak into real codewords.
//   * The whole decoder state lives in dynamic shared memory for all
//     iterations: L[n], P[n] and R[E*Z] float32, (2n + E*Z)*4 bytes (about
//     21 KB for the judged (1024, 512) code).  Messages never go to device
//     memory mid-decode.
//   * CN pass: one thread per check (i, r).  Pass 1 over the row's edges
//     in edge order gathers q_e = P[col_e*Z + (r+s_e) mod Z] - R[e*Z+r]
//     and feeds the CN update (bp_common.cuh: MinSum, SumProduct or
//     SumProductFast); pass 2 recomputes q_e (same operands, same
//     rounding) and writes R_e = cn.out(e, q_e).  Two passes keep no
//     per-row array.
//   * VN pass: one thread per variable (j, v): p = L + sum of
//     R[e*Z + (v-s_e) mod Z] in ascending block-row order.  No atomics:
//     they would change the summation order.
//   * Quantization is a policy beside the CN update (bp_common.cuh:
//     NoQuant, Quant), applied at golden's four points: the LLRs as they
//     load (L and P start on the grid), q saturated before cn.add and
//     cn.out (both passes recompute the same value), cn.out quantized
//     before R is stored, the posterior saturated after the VN sum.
//   * Early termination with golden semantics (golden/decoder.py:21-25):
//     the CN pass of iteration `it` also counts violated checks of the
//     pre-pass posterior P_{it-1} (it=1 checks the channel decision);
//     __syncthreads_or turns the counts into one block-wide verdict and
//     the block exits at the first zero with iters_used = it-1.  After the
//     last iteration one standalone syndrome gives ok; iters_used = iters.
//   * Built with -fmad=false: no product may be fused into an add
//     unrounded.  Sum-product calls tanhf / logf (no fast-math), which
//     round differently from PyTorch's CPU functions, so it agrees with
//     the plain version frame by frame, not bit for bit; min-sum (float or
//     quantized) and sumproduct-fast are bit-exact.
//
// What bounds it on the card: shared-memory gather bandwidth and
// instruction issue (min-sum; sumproduct-fast adds a three-smallest scan
// and three PWL soft-mins per check, quantization a floor, a division and
// clips per edge), plus two transcendentals per edge and pass
// (sum-product: tanhf and logf in each of phi(|q|) and phi(tot - phi_e)).
// Per codeword and iteration it makes about 5*E*Z shared-memory reads
// plus the index arithmetic of each circulant gather.  This first design
// keeps every access in shared memory with consecutive threads on
// consecutive Z offsets (conflict-free but for the wrap), and does
// nothing else about it: several codewords per block, a warp per row,
// single-pass scans in registers and packed messages are later work.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kThreads = 256;

template <class CN, class QP>
__global__ void __launch_bounds__(kThreads)
bp_flood_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                const int32_t* __restrict__ edge_col,
                const int32_t* __restrict__ edge_shift,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col_slots,
                const int32_t* __restrict__ col_deg, int Z, int mb, int nb,
                int E, int max_col_deg, int iters, CN proto, QP quant,
                int early_stop) {
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* L = smem;
  float* P = L + n;
  float* R = P + n;  // E * Z messages, check coordinates
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const float x = quant.quantize(llr_b[v]);
    L[v] = x;
    P[v] = x;
  }
  for (int t = threadIdx.x; t < E * Z; t += blockDim.x) R[t] = 0.0f;
  __syncthreads();

  int converged_at = -1;  // block-uniform
  for (int it = 1; it <= iters; ++it) {
    // ---- CN pass (+ syndrome of the pre-pass posterior) ----
    int viol = 0;
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      const int i = c / Z;
      const int r = c - i * Z;
      const int e0 = row_ptr[i];
      const int e1 = row_ptr[i + 1];
      CN cn = proto;
      cn.begin();
      int parity = 0;
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        cn.add(e - e0, quant.sat(p - R[e * Z + r]));
        parity ^= p < 0.0f;
      }
      cn.finish(e1 - e0);
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        R[e * Z + r] =
            quant.quantize(cn.out(e - e0, quant.sat(p - R[e * Z + r])));
      }
      viol += parity;
    }
    if (early_stop) {
      if (!__syncthreads_or(viol)) {
        converged_at = it - 1;
        break;
      }
    } else {
      __syncthreads();
    }

    // ---- VN pass: ascending block-row order, no atomics ----
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const int j = v / Z;
      const int z = v - j * Z;
      float p = L[v];
      const int32_t* slots = col_slots + j * max_col_deg;
      for (int t = 0; t < col_deg[j]; ++t) {
        const int e = slots[t];
        p = p + R[e * Z + wrap_sub(z, edge_shift[e], Z)];
      }
      P[v] = quant.sat_post(p);
    }
    __syncthreads();
  }

  int ok;
  int iters_used;
  if (converged_at >= 0) {
    ok = 1;
    iters_used = converged_at;
  } else {
    // final posterior: one standalone syndrome (ET on or off alike)
    ok = !__syncthreads_or(
        count_violations(P, edge_col, edge_shift, row_ptr, Z, m));
    iters_used = iters;
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
                   const int32_t* col_slots, const int32_t* col_deg,
                   int batch, int Z, int mb, int nb, int E, int max_col_deg,
                   int iters, float alpha, float beta, QP quant,
                   int early_stop, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bp_flood_kernel<CN, QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = alpha;
  proto.beta = beta;
  bp_flood_kernel<CN, QP><<<batch, kThreads, smem, stream>>>(
      llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr, col_slots,
      col_deg, Z, mb, nb, E, max_col_deg, iters, proto, quant, early_stop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t ldpc_bp_flood_smem_bytes(int Z, int nb, int E) {
  return (2 * (size_t)nb * Z + (size_t)E * Z) * sizeof(float);
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast (ldpc::Algo).
// quantized != 0 selects fixed-point min-sum on the grid `step` (a power
// of two) with largest index `kmax` and saturation limits `lim_msg` /
// `lim_post`; with any other algo it returns cudaErrorInvalidValue.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_flood(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                  int32_t* iters_used, const int32_t* edge_col,
                  const int32_t* edge_shift, const int32_t* row_ptr,
                  const int32_t* col_slots, const int32_t* col_deg,
                  int batch, int Z, int mb, int nb, int E, int max_col_deg,
                  int iters, float alpha, float beta, int early_stop,
                  int quantized, float step, float kmax, float lim_msg,
                  float lim_post, void* stream) {
  const size_t smem = ldpc_bp_flood_smem_bytes(Z, nb, E);
  const cudaStream_t s = (cudaStream_t)stream;
#define LDPC_LAUNCH(CN, QUANT)                                              \
  launch<CN>(llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr,     \
             col_slots, col_deg, batch, Z, mb, nb, E, max_col_deg, iters,  \
             alpha, beta, QUANT, early_stop, smem, s)
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
