// Flooding normalized / offset min-sum LDPC decoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_ldpc/decode/pallas_bp.py::build_pallas_decoder
// `kernel`, flooding branch (cn_pass_fused, _cn_minsum_kernel, vn_pass,
// latch, syndrome_violations and the final check, pallas_bp.py:514-707).
// It ports WHAT that kernel computes, not its TPU layout (codewords on
// lanes, Z on sublanes, static rolls):
//
//   * One thread block per codeword; grid = batch.  Nothing is padded, so
//     no padding can leak into real codewords.
//   * The whole decoder state lives in dynamic shared memory for all
//     iterations: L[n], P[n] and R[E*Z] float32, (2n + E*Z)*4 bytes (about
//     21 KB for the judged (1024, 512) code).  Messages never go to device
//     memory mid-decode.
//   * CN pass: one thread per check (i, r).  Pass 1 over the row's edges
//     in edge order gathers q_e = P[col_e*Z + (r+s_e) mod Z] - R[e*Z+r]
//     and runs the golden sequential two-min scan (first-occurrence
//     argmin) and sign parity; pass 2 recomputes q_e (same operands, same
//     rounding) and writes R_e = (total_sign*sign_e) * (alpha*max(m-beta,0)).
//     Two passes keep no per-row array, so the row degree is unbounded.
//   * VN pass: one thread per variable (j, v): p = L + sum of
//     R[e*Z + (v-s_e) mod Z] in ascending block-row order.  No atomics:
//     they would change the summation order.
//   * Early termination with golden semantics (golden/decoder.py:21-25):
//     the CN pass of iteration `it` also counts violated checks of the
//     pre-pass posterior P_{it-1} (it=1 checks the channel decision);
//     __syncthreads_or turns the counts into one block-wide verdict and
//     the block exits at the first zero with iters_used = it-1.  After the
//     last iteration one standalone syndrome gives ok; iters_used = iters.
//   * Signs, the syndrome and the hard decision all read `x < 0`, as the
//     golden model does: -0.0 is positive everywhere.
//   * Built with -fmad=false: no product may be fused into an add
//     unrounded (none does today; the flag pins the contract).
//
// What bounds it on the card: shared-memory gather bandwidth and
// instruction issue.  Per codeword and iteration it makes about 5*E*Z
// shared-memory reads (4 in the two CN passes, 1 in the VN pass) plus the
// index arithmetic of each circulant gather.  This first design keeps every
// access in shared memory with consecutive threads on consecutive Z
// offsets (conflict-free but for the wrap), and does nothing else about
// it: several codewords per block, a warp per row, single-pass scans in
// registers and packed messages are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (a + b) mod Z and (a - b) mod Z for a, b in [0, Z): a conditional
// add or subtract, never C's `%` (which keeps the sign of a negative
// dividend).  Works for odd Z.
__device__ __forceinline__ int wrap_add(int a, int b, int Z) {
  const int x = a + b;
  return x >= Z ? x - Z : x;
}

__device__ __forceinline__ int wrap_sub(int a, int b, int Z) {
  const int x = a - b;
  return x < 0 ? x + Z : x;
}

// Violated checks of hard(P) among this thread's checks.
__device__ int count_violations(const float* P, const int32_t* edge_col,
                                const int32_t* edge_shift,
                                const int32_t* row_ptr, int Z, int m) {
  int viol = 0;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    const int i = c / Z;
    const int r = c - i * Z;
    int parity = 0;
    for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
      parity ^= P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)] < 0.0f;
    }
    viol += parity;
  }
  return viol;
}

__global__ void __launch_bounds__(kThreads)
minsum_flood_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                    uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                    const int32_t* __restrict__ edge_col,
                    const int32_t* __restrict__ edge_shift,
                    const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ col_slots,
                    const int32_t* __restrict__ col_deg, int Z, int mb,
                    int nb, int E, int max_col_deg, int iters, float alpha,
                    float beta, int early_stop) {
  extern __shared__ float smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  float* L = smem;
  float* P = L + n;
  float* R = P + n;  // E * Z messages, check coordinates
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const float x = llr_b[v];
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
      float min1 = 0.0f;
      float min2 = INFINITY;
      int argmin = e0;
      int neg = 0;
      int parity = 0;
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        const float q = p - R[e * Z + r];
        const float mag = fabsf(q);
        neg ^= q < 0.0f;
        parity ^= p < 0.0f;
        if (e == e0) {
          min1 = mag;
        } else if (mag < min1) {
          min2 = min1;
          min1 = mag;
          argmin = e;
        } else {
          min2 = fminf(min2, mag);
        }
      }
      if (e1 - e0 == 1) min2 = min1;  // single-edge row: own magnitude
      const float total_sign = neg ? -1.0f : 1.0f;
      for (int e = e0; e < e1; ++e) {
        const float p = P[edge_col[e] * Z + wrap_add(r, edge_shift[e], Z)];
        const float q = p - R[e * Z + r];
        const float sign = q < 0.0f ? -1.0f : 1.0f;
        const float mag_excl = fmaxf((e == argmin ? min2 : min1) - beta, 0.0f);
        R[e * Z + r] = (total_sign * sign) * (alpha * mag_excl);
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t ldpc_minsum_flood_smem_bytes(int Z, int nb, int E) {
  return (2 * (size_t)nb * Z + (size_t)E * Z) * sizeof(float);
}

// Launches one block per codeword on `stream` (a cudaStream_t) of the
// current CUDA device; the caller makes the device of `stream` current.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_minsum_flood(const float* llr, uint8_t* bits, uint8_t* ok,
                      int32_t* iters_used, const int32_t* edge_col,
                      const int32_t* edge_shift, const int32_t* row_ptr,
                      const int32_t* col_slots, const int32_t* col_deg,
                      int batch, int Z, int mb, int nb, int E,
                      int max_col_deg, int iters, float alpha, float beta,
                      int early_stop, void* stream) {
  const size_t smem = ldpc_minsum_flood_smem_bytes(Z, nb, E);
  cudaError_t err = cudaFuncSetAttribute(minsum_flood_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  minsum_flood_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      llr, bits, ok, iters_used, edge_col, edge_shift, row_ptr, col_slots,
      col_deg, Z, mb, nb, E, max_col_deg, iters, alpha, beta, early_stop);
  return (int)cudaGetLastError();
}

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
