// Layered BP decoder (normalized / offset min-sum, exact sum-product,
// sumproduct-fast and fixed-point quantized min-sum, with R in float32 or
// bf16, in plain or normalized coordinates) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel`, layered branch (one_iter, pallas_bp.py:608-634, with latch and
// syndrome_violations), its CN updates _cn_minsum_kernel (219-233),
// _cn_sumproduct_kernel / _phi (236-238, 306-321) and
// _cn_sumproduct_fast_kernel / _ctilde_k / _fpair_k (241-303), and its
// quantized mode (qz / sat_msg / sat_post, 459-473, applied at 617-628 and
// 885-887), bf16 message storage (msg_dtype, load_R / store_R, 487-492)
// and shift normalization (_normalize_offsets 108-208; the layered
// branch rotates straight into P and un-rotates the bits, 876-878,
// 687-707).  What it computes is golden's row-layered schedule
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
// Under bf16 storage (Bf16Msg) q reads the rounded R, the posterior
// update takes the unrounded r_e, and only the store into R rounds
// (pallas_bp.py:612-629).  Shift normalization passes the effective
// shifts in edge_shift and the column offsets in col_off (null in plain
// coordinates): the coalesced LLR load stores P at the rotated index and
// the coalesced bit store reads it from there (state_index), with no
// extra pass.
//
// Design:
//   * One thread block per codeword; grid = batch.  P[n] and R[E*Z] stay
//     in dynamic shared memory for all iterations, 4n + 4EZ bytes, or
//     4n + 2EZ under bf16 (17,152 or 10,624 B for the judged code).
//     There is no L array: the layered update never reads the channel
//     LLRs again.
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

template <class CN, class QP, class MP>
__global__ void __launch_bounds__(kMaxThreads)
bp_layered_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                  uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                  const int32_t* __restrict__ edge_col,
                  const int32_t* __restrict__ edge_shift,
                  const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ col_off, int Z, int mb, int nb,
                  int E, int iters, CN proto, QP quant, int early_stop) {
  using Msg = typename MP::T;
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* P = smem;
  Msg* R = reinterpret_cast<Msg*>(P + n);  // E * Z, check coordinates
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    P[state_index(v, col_off, Z)] = quant.quantize(llr_b[v]);
  }
  for (int t = threadIdx.x; t < E * Z; t += blockDim.x) R[t] = MP::store(0.0f);
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
          cn.add(e - e0, quant.sat(P[v] - MP::load(R[e * Z + r])));
        }
        cn.finish(e1 - e0);
        for (int e = e0; e < e1; ++e) {
          const int v = edge_col[e] * Z + wrap_add(r, edge_shift[e], Z);
          const float q = P[v] - MP::load(R[e * Z + r]);
          const float r_new = quant.quantize(cn.out(e - e0, quant.sat(q)));
          P[v] = quant.sat_post(q + r_new);  // the unrounded message
          R[e * Z + r] = MP::store(r_new);
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
  const int32_t *edge_col, *edge_shift, *row_ptr, *col_off;
  int batch, Z, mb, nb, E, iters;
  float alpha, beta;
  int early_stop, threads;
  size_t smem;
  cudaStream_t stream;
};

template <class CN, class MP, class QP = NoQuant>
cudaError_t launch(const Args& a, QP quant = QP{}) {
  auto kernel = bp_layered_kernel<CN, QP, MP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = a.alpha;
  proto.beta = a.beta;
  kernel<<<a.batch, a.threads, a.smem, a.stream>>>(
      a.llr, a.bits, a.ok, a.iters_used, a.edge_col, a.edge_shift,
      a.row_ptr, a.col_off, a.Z, a.mb, a.nb, a.E, a.iters, proto, quant,
      a.early_stop);
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

// Bytes of dynamic shared memory one block needs: P in float32, R in
// float32 or (msg_bf16 != 0) bf16.
size_t ldpc_bp_layered_smem_bytes(int Z, int nb, int E, int msg_bf16) {
  return (size_t)nb * Z * sizeof(float) +
         (size_t)E * Z * (msg_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Threads of one block: one per check of a block-row, in whole warps.
int ldpc_bp_layered_threads(int Z) {
  const int t = (Z + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast (ldpc::Algo).
// edge_shift: the effective shifts and col_off the column offsets of shift
// normalization (the layout's shifts and NULL without it).
// msg_bf16 != 0 stores R in bf16.  quantized != 0 selects fixed-point
// min-sum on the grid `step` (a power of two) with largest index `kmax`
// and saturation limits `lim_msg` / `lim_post`; with another algo, with
// bf16 or with a step that is not a power of two it returns
// cudaErrorInvalidValue.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_layered(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                    int32_t* iters_used, const int32_t* edge_col,
                    const int32_t* edge_shift, const int32_t* row_ptr,
                    const int32_t* col_off, int batch, int Z, int mb, int nb,
                    int E, int iters, float alpha, float beta, int early_stop,
                    int msg_bf16, int quantized, float step, float kmax,
                    float lim_msg, float lim_post, void* stream) {
  const Args a{llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr,
               col_off, batch, Z, mb, nb, E, iters, alpha, beta, early_stop,
               ldpc_bp_layered_threads(Z),
               ldpc_bp_layered_smem_bytes(Z, nb, E, msg_bf16),
               (cudaStream_t)stream};
  if (quantized) {
    Quant quant;
    if (algo != kMinSum || msg_bf16 ||
        !make_quant(step, kmax, lim_msg, lim_post, &quant)) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)launch<MinSum, F32Msg>(a, quant);
  }
  return (int)(msg_bf16 ? launch_algo<Bf16Msg>(algo, a)
                        : launch_algo<F32Msg>(algo, a));
}

}  // extern "C"
