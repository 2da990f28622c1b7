// Flooding min-sum with compressed row state for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel_compressed` (709-857, scratches 859-867, `reconstruct` 734-742).
// In place of E*Z per-edge CN->VN messages each check keeps its row state:
// m1 and m2 (the two output magnitudes, alpha * max(min - beta, 0)), the
// argmin slot and a sign byte whose bit t is the sign of slot t's message
// (bp_common.cuh: pack_signs, reconstruct).  That describes every message
// of the check exactly, so the decode is bit-exact with golden, like the
// flooding kernel K1 (bp_flood.cu).  Signs read `x < 0`, as golden's and
// the rest of the port's do; the Pallas kernel reads sign bits, so q =
// -0.0 counts as negative there.  The sign byte limits rows to degree 8.
//
// Design:
//   * One thread block per codeword; grid = batch.  Shared memory holds
//     L[n], P[n] float32 and the row state of the m = mb*Z checks: m1[m],
//     m2[m] float32, arg[m], sgn[m] uint8, 8n + 10m bytes (13,312 B for
//     the judged (1024, 512) code, against K1's 21,248).
//   * CN pass, one thread per check (i, r), a single pass over the row's
//     edges in edge order: q_e = P[col_e*Z + (r+s_e) mod Z] minus the
//     message rebuilt from the check's old state, fed to golden's two-min
//     scan (MinSum) while the own signs gather into a byte; then the new
//     state is written over the old.  K1 needs a second pass to write
//     each edge's message; here the state is the output.
//   * VN pass, one thread per variable (j, z): p = L + the messages of the
//     column's edges in ascending block-row order, each rebuilt from the
//     state of check (z - s_e) mod Z of its row.
//   * Early termination and the final syndrome as in bp_flood.cu: the CN
//     pass of iteration `it` counts violated checks of P_{it-1}; the block
//     exits at the first zero with iters_used = it-1.
//   * Built with -fmad=false like the other kernels.
//
// What bounds it on the card: instruction issue and shared-memory gathers,
// as for K1: per edge and iteration one gather of P and one rebuilt message
// (two selects on four state loads) in the CN pass and one in the VN pass,
// against K1's two gathers and a message load and store in the CN pass.
// It moves fewer shared-memory bytes than K1 and issues about as many
// instructions.  Several codewords per block and a warp per row are later
// work, as for K1.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bp_compressed_kernel(const float* __restrict__ llr,
                     uint8_t* __restrict__ bits, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ iu_out,
                     const int32_t* __restrict__ edge_row,
                     const int32_t* __restrict__ edge_col,
                     const int32_t* __restrict__ edge_shift,
                     const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ col_slots,
                     const int32_t* __restrict__ col_deg, int Z, int mb,
                     int nb, int max_col_deg, int iters, MinSum proto,
                     int early_stop) {
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* L = smem;
  float* P = L + n;
  float* M1 = P + n;  // row state of check c = i * Z + r
  float* M2 = M1 + m;
  uint8_t* ARG = reinterpret_cast<uint8_t*>(M2 + m);
  uint8_t* SGN = ARG + m;
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    L[v] = llr_b[v];
    P[v] = llr_b[v];
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    M1[c] = 0.0f;
    M2[c] = 0.0f;
    ARG[c] = 0;
    SGN[c] = 0;
  }
  __syncthreads();

  int converged_at = -1;  // block-uniform
  for (int it = 1; it <= iters; ++it) {
    // ---- CN pass, single pass (+ syndrome of the pre-pass posterior) ----
    int viol = 0;
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      const int i = c / Z;
      const int r = c - i * Z;
      const int e0 = row_ptr[i];
      const int e1 = row_ptr[i + 1];
      const float m1 = M1[c];
      const float m2 = M2[c];
      const int arg = ARG[c];
      const int sgn = SGN[c];
      MinSum cn = proto;
      cn.begin();
      int own = 0;
      int parity = 0;
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        const float q = p - reconstruct(m1, m2, arg, sgn, e - e0);
        cn.add(e - e0, q);
        own |= (q < 0.0f) << (e - e0);
        parity ^= p < 0.0f;
      }
      cn.finish(e1 - e0);
      M1[c] = cn.scaled(cn.min1);
      M2[c] = cn.scaled(cn.min2);
      ARG[c] = (uint8_t)cn.argmin;
      SGN[c] = (uint8_t)pack_signs(cn.neg, own, e1 - e0);
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

    // ---- VN pass: ascending block-row order, messages rebuilt ----
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const int j = v / Z;
      const int z = v - j * Z;
      float p = L[v];
      const int32_t* slots = col_slots + j * max_col_deg;
      for (int t = 0; t < col_deg[j]; ++t) {
        const int e = slots[t];
        const int i = edge_row[e];
        const int c = i * Z + wrap_sub(z, edge_shift[e], Z);
        p = p + reconstruct(M1[c], M2[c], ARG[c], SGN[c], e - row_ptr[i]);
      }
      P[v] = p;
    }
    __syncthreads();
  }

  int ok;
  int iters_used;
  if (converged_at >= 0) {
    ok = 1;
    iters_used = converged_at;
  } else {
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t ldpc_bp_compressed_smem_bytes(int Z, int mb, int nb) {
  return 2 * (size_t)nb * Z * sizeof(float) +
         (size_t)mb * Z * (2 * sizeof(float) + 2);
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// Rows of degree above 8 return cudaErrorInvalidValue (the sign byte).
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_compressed(const float* llr, uint8_t* bits, uint8_t* ok,
                       int32_t* iters_used, const int32_t* edge_row,
                       const int32_t* edge_col, const int32_t* edge_shift,
                       const int32_t* row_ptr, const int32_t* col_slots,
                       const int32_t* col_deg, int batch, int Z, int mb,
                       int nb, int max_row_deg, int max_col_deg, int iters,
                       float alpha, float beta, int early_stop,
                       void* stream) {
  if (max_row_deg > 8) return (int)cudaErrorInvalidValue;
  const size_t smem = ldpc_bp_compressed_smem_bytes(Z, mb, nb);
  cudaError_t err = cudaFuncSetAttribute(
      bp_compressed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  MinSum proto;
  proto.alpha = alpha;
  proto.beta = beta;
  bp_compressed_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      llr, bits, ok, iters_used, edge_row, edge_col, edge_shift, row_ptr,
      col_slots, col_deg, Z, mb, nb, max_col_deg, iters, proto, early_stop);
  return (int)cudaGetLastError();
}

}  // extern "C"
