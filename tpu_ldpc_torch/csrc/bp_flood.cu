// Flooding BP decoder (normalized / offset min-sum, exact sum-product,
// sumproduct-fast, fixed-point quantized min-sum and rescaled min-sum,
// with R in float32 or bf16, in plain or normalized coordinates) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel`, flooding branch (cn_pass_fused, vn_pass, latch,
// syndrome_violations and the final check, pallas_bp.py:514-707) with its
// CN updates _cn_minsum_kernel (219-233), _cn_sumproduct_kernel / _phi
// (236-238, 306-321) and _cn_sumproduct_fast_kernel / _ctilde_k /
// _fpair_k (241-303), its quantized mode (qz / sat_msg / sat_post,
// 459-473, applied at 557-561, 583 and 885-887), bf16 message storage
// (msg_dtype, load_R / store_R, 487-492), the rescaled contract
// (rescaled=True, 443-450, 526-533, 574-580) and shift normalization
// (_normalize_offsets 108-208, applied at 426-438, 524-534, 687-707).  It
// ports WHAT that kernel computes, not its TPU layout (codewords on lanes,
// Z on sublanes, static rolls):
//
//   * One thread block per codeword; grid = batch.  Nothing is padded, so
//     no padding can leak into real codewords.
//   * The whole decoder state lives in dynamic shared memory for all
//     iterations: L[n], P[n] float32 and R[E*Z] (float32 or bf16),
//     8n + 4EZ or 8n + 2EZ bytes (21,248 or 14,720 B for the judged
//     (1024, 512) code).  Messages never go to device memory mid-decode.
//   * CN pass: one thread per check (i, r).  Pass 1 over the row's edges
//     in edge order gathers q_e = P[col_e*Z + (r+s_e) mod Z] - R[e*Z+r]
//     and feeds the CN update (bp_common.cuh: MinSum, MinSumUnit,
//     SumProduct or SumProductFast); pass 2 recomputes q_e (same operands,
//     same rounding) and writes R_e = cn.out(e, q_e).  Two passes keep no
//     per-row array.
//   * VN pass: one thread per variable (j, v): p = L + sum of
//     R[e*Z + (v-s_e) mod Z] in ascending block-row order.  No atomics:
//     they would change the summation order.
//   * Quantization is a policy beside the CN update (bp_common.cuh:
//     NoQuant, Quant), applied at golden's four points: the LLRs as they
//     load (L and P start on the grid), q saturated before cn.add and
//     cn.out (both passes recompute the same value), cn.out quantized
//     before R is stored, the posterior saturated after the VN sum.
//   * Message storage is a policy too (F32Msg, Bf16Msg): R is rounded to
//     bf16 as it is stored and widened as it is read, so the CN's q and
//     the VN sums both see the rounded message, as in the Pallas kernel.
//   * Rescaled (kRescaled, with MinSumUnit): L holds the scaled channel
//     term, LLR * (1/alpha) at entry; each VN pass reads it for its sum
//     and stores it times 1/alpha for the next iteration.  The product
//     only feeds a store.
//   * Shift normalization is relabeling: the host passes the effective
//     shifts (s + d_i - c_j) mod Z in edge_shift and the column offsets
//     c_j in col_off (null in plain coordinates).  The coalesced LLR load
//     stores into the state at the rotated index, the coalesced bit store
//     reads from it (state_index): no extra pass or buffer, and plain
//     coordinates read no offset at all.  A zero shift takes the
//     same wrap arithmetic as any other: a branch that skipped it made
//     every kernel 4-7% slower on the card and the normalized kernels no
//     faster (PERF.md).
//   * Early termination with golden semantics (golden/decoder.py:21-25):
//     the CN pass of iteration `it` also counts violated checks of the
//     pre-pass posterior P_{it-1} (it=1 checks the channel decision);
//     __syncthreads_or turns the counts into one block-wide verdict and
//     the block exits at the first zero with iters_used = it-1.  After the
//     last iteration one standalone syndrome gives ok; iters_used = iters.
//     A block's bits come from its final P only, so no latched bits need
//     merging before the un-rotation.
//   * Built with -fmad=false: no product may be fused into an add
//     unrounded.  Sum-product calls tanhf / logf (no fast-math), which
//     round differently from PyTorch's CPU functions, so it agrees with
//     the plain version frame by frame, not bit for bit; every other mode
//     is bit-exact.
//
// What bounds it on the card: shared-memory gather bandwidth and
// instruction issue (min-sum; sumproduct-fast adds a three-smallest scan
// and three PWL soft-mins per check, quantization a floor, a division and
// clips per edge, bf16 a conversion per message load and store), plus two
// transcendentals per edge and pass (sum-product: tanhf and logf in each
// of phi(|q|) and phi(tot - phi_e)).  Per codeword and iteration it makes
// about 5*E*Z shared-memory reads plus the index arithmetic of each
// circulant gather.  This first design keeps every access in shared
// memory with consecutive threads on consecutive Z offsets (conflict-free
// but for the wrap), and does nothing else about it: several codewords
// per block, a warp per row, single-pass scans in registers and packed
// messages are later work.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kThreads = 256;

template <class CN, class QP, class MP, bool kRescaled>
__global__ void __launch_bounds__(kThreads)
bp_flood_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                const int32_t* __restrict__ edge_col,
                const int32_t* __restrict__ edge_shift,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col_slots,
                const int32_t* __restrict__ col_deg,
                const int32_t* __restrict__ col_off, int Z, int mb, int nb,
                int E, int max_col_deg, int iters, CN proto, QP quant,
                float inv_alpha, int early_stop) {
  using Msg = typename MP::T;
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* L = smem;
  float* P = L + n;
  Msg* R = reinterpret_cast<Msg*>(P + n);  // E * Z, check coordinates
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const float x = quant.quantize(llr_b[v]);
    const int u = state_index(v, col_off, Z);
    L[u] = kRescaled ? x * inv_alpha : x;
    P[u] = x;
  }
  for (int t = threadIdx.x; t < E * Z; t += blockDim.x) R[t] = MP::store(0.0f);
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
        cn.add(e - e0, quant.sat(p - MP::load(R[e * Z + r])));
        parity ^= p < 0.0f;
      }
      cn.finish(e1 - e0);
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        R[e * Z + r] = MP::store(quant.quantize(
            cn.out(e - e0, quant.sat(p - MP::load(R[e * Z + r])))));
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
      // rescaled: the next iteration's channel term; the product feeds
      // only this store
      if (kRescaled) L[v] = p * inv_alpha;
      const int32_t* slots = col_slots + j * max_col_deg;
      for (int t = 0; t < col_deg[j]; ++t) {
        const int e = slots[t];
        p = p + MP::load(R[e * Z + wrap_sub(z, edge_shift[e], Z)]);
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
    bits_b[v] = P[state_index(v, col_off, Z)] < 0.0f;
  }
  if (threadIdx.x == 0) {
    ok_out[b] = (uint8_t)ok;
    iu_out[b] = iters_used;
  }
}

struct Args {
  const float* llr;
  uint8_t* bits;
  uint8_t* ok;
  int32_t* iters_used;
  const int32_t *edge_col, *edge_shift, *row_ptr, *col_slots, *col_deg,
      *col_off;
  int batch, Z, mb, nb, E, max_col_deg, iters;
  float alpha, beta, inv_alpha;
  int early_stop;
  size_t smem;
  cudaStream_t stream;
};

template <class CN, class MP, bool kRescaled = false, class QP = NoQuant>
cudaError_t launch(const Args& a, QP quant = QP{}) {
  auto kernel = bp_flood_kernel<CN, QP, MP, kRescaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = a.alpha;
  proto.beta = a.beta;
  kernel<<<a.batch, kThreads, a.smem, a.stream>>>(
      a.llr, a.bits, a.ok, a.iters_used, a.edge_col, a.edge_shift,
      a.row_ptr, a.col_slots, a.col_deg, a.col_off, a.Z, a.mb, a.nb, a.E,
      a.max_col_deg, a.iters, proto, quant, a.inv_alpha, a.early_stop);
  return cudaGetLastError();
}

template <class MP>
cudaError_t launch_algo(int algo, const Args& a) {
  if (algo == kMinSum) return launch<MinSum, MP>(a);
  if (algo == kSumProduct) return launch<SumProduct, MP>(a);
  if (algo == kSumProductFast) return launch<SumProductFast, MP>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs: L and P in float32,
// R in float32 or (msg_bf16 != 0) bf16.
size_t ldpc_bp_flood_smem_bytes(int Z, int nb, int E, int msg_bf16) {
  return 2 * (size_t)nb * Z * sizeof(float) +
         (size_t)E * Z * (msg_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast (ldpc::Algo).
// edge_shift: the effective shifts and col_off the column offsets of shift
// normalization (the layout's shifts and NULL without it).
// msg_bf16 != 0 stores R in bf16.  rescaled != 0 selects rescaled min-sum
// (alpha is then ignored, inv_alpha = fp32(1)/fp32(alpha) scales L).
// quantized != 0 selects fixed-point min-sum on the grid `step` (a power
// of two) with largest index `kmax` and saturation limits `lim_msg` /
// `lim_post`.  Quantized or rescaled with another algo, or with bf16, and
// both together, return cudaErrorInvalidValue.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_flood(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                  int32_t* iters_used, const int32_t* edge_col,
                  const int32_t* edge_shift, const int32_t* row_ptr,
                  const int32_t* col_slots, const int32_t* col_deg,
                  const int32_t* col_off, int batch, int Z, int mb, int nb,
                  int E, int max_col_deg, int iters, float alpha, float beta,
                  int early_stop, int msg_bf16, int rescaled,
                  float inv_alpha, int quantized, float step, float kmax,
                  float lim_msg, float lim_post, void* stream) {
  const Args a{llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr,
               col_slots, col_deg, col_off, batch, Z, mb, nb, E,
               max_col_deg, iters, alpha, beta, inv_alpha, early_stop,
               ldpc_bp_flood_smem_bytes(Z, nb, E, msg_bf16),
               (cudaStream_t)stream};
  if (quantized || rescaled) {
    if (algo != kMinSum || msg_bf16 || (quantized && rescaled)) {
      return (int)cudaErrorInvalidValue;
    }
    if (rescaled) return (int)launch<MinSumUnit, F32Msg, true>(a);
    return (int)launch<MinSum, F32Msg, false>(
        a, Quant{step, kmax, lim_msg, lim_post});
  }
  return (int)(msg_bf16 ? launch_algo<Bf16Msg>(algo, a)
                        : launch_algo<F32Msg>(algo, a));
}

}  // extern "C"
