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
// What it computes, per codeword (one thread block; grid = batch):
//   * CN pass, check c = (i, r), one pass over its row in edge order:
//     q_t = P[col_t*Z + (r+s_t) mod Z] minus slot t's message rebuilt from
//     the check's old state, fed to golden's two-min scan (MinSum) while
//     the own signs gather into a byte; the new state is written over the
//     old.  The pass also counts violated checks of the pre-pass posterior
//     P_{it-1}, as the Pallas kernel's fused syndrome does.
//   * VN pass, variable (j, z): p = L + the messages of the column's
//     edges in ascending block-row order, each rebuilt from the state of
//     check (z - s_e) mod Z of its row.  No atomics: they would change the
//     summation order.
//   * Early termination as in bp_flood.cu: the block exits at the first
//     CN pass with no violated check, iters_used = it-1; otherwise one
//     standalone syndrome after the last iteration gives ok.
//   * Built with -fmad=false like the other kernels.
//
// Design (decode/flood_plan.py::compressed_plan builds the tables):
//   * Shared memory holds the row state, 16 B a check (m1, m2 as float
//     bits, argmin | signs << 8, unused), so one message is rebuilt from
//     one 16-byte load; then L[n] and P[n].
//   * One thread per check for the whole decode, in whole warps (512 on
//     the judged code): its row's P indices, already rotated by the host
//     (cn_p), sit in registers from the prologue on, and each CN pass is
//     dispatched on the row's exact degree (a switch, uniform across a
//     warp of one block-row's checks) to straight-line code.
//   * The VN pass reads a per-variable table in shared memory: vn_info
//     (the column's degree and the variable's first edge slot, as in
//     bp_flood.cu) and vn_check, per edge slot and variable the check
//     index and slot of its message, in ascending block-row order.  The
//     iteration loop has no wrap, no division and no load from device
//     memory.
//   * A code with more than 1024 checks, or whose tables exceed shared
//     memory, runs kOneCheck = false: 256 threads walk the checks and read
//     the same tables from device memory.
//
// What bounds it on the card: instruction issue and shared-memory latency,
// as for K1: per edge and iteration one gather of P and one message
// rebuilt from the check's state in the CN pass, one table load and one
// state load in the VN pass.  It keeps 16m bytes of messages where K1
// keeps 4EZ.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kSlots = 8;  // the sign byte
constexpr int kOneCheckThreads = 1024;
constexpr int kGenericThreads = 256;
constexpr int kVnBaseBits = 17;  // vn_info = (col_deg << 17) | edge slot
constexpr uint32_t kVnBaseMask = (1u << kVnBaseBits) - 1;

constexpr int max_threads(bool one_check) {
  return one_check ? kOneCheckThreads : kGenericThreads;
}

// decode/flood_plan.py::compressed_plan's tables in device memory.
struct Tables {
  const int32_t *cn_p, *cn_deg, *vn_info, *vn_check;
};

// A check's row state (16 B in shared memory).
struct RowState {
  float m1, m2;
  int arg, sgn;

  __device__ __forceinline__ static RowState load(const uint4* st, int c) {
    const uint4 w = st[c];
    return RowState{__uint_as_float(w.x), __uint_as_float(w.y),
                    (int)(w.z & 0xffu), (int)(w.z >> 8)};
  }
  __device__ __forceinline__ float message(int t) const {
    return reconstruct(m1, m2, arg, sgn, t);
  }
};

// One CN pass over check c: its row's P indices, the new state written
// over the old.  Returns the parity of the pre-pass hard decisions.
// kDeg > 0: the row has exactly kDeg slots (straight-line code); kDeg =
// 0: up to kSlots under `t < deg` predicates.
template <int kDeg>
__device__ __forceinline__ int cn_check(const int* idx, int deg, int c,
                                        const float* P, uint4* ST,
                                        const MinSum& proto) {
  const RowState old = RowState::load(ST, c);
  MinSum cn = proto;
  cn.begin();
  int own = 0;
  int parity = 0;
#pragma unroll
  for (int t = 0; t < (kDeg ? kDeg : kSlots); ++t) {
    if (kDeg || t < deg) {
      const float p = P[idx[t]];
      const float q = p - old.message(t);
      cn.add(t, q);
      own |= (q < 0.0f) << t;
      parity ^= p < 0.0f;
    }
  }
  cn.finish(deg);
  ST[c] = make_uint4(__float_as_uint(cn.s1), __float_as_uint(cn.s2),
                     (uint32_t)cn.argmin |
                         (uint32_t)pack_signs(cn.neg, own, deg) << 8,
                     0u);
  return parity;
}

// cn_check on the row's exact degree (uniform across a warp of one
// block-row's checks).
__device__ __forceinline__ int cn_pass(const int* idx, int deg, int c,
                                       const float* P, uint4* ST,
                                       const MinSum& proto) {
  switch (deg) {
    case 1:
      return cn_check<1>(idx, deg, c, P, ST, proto);
    case 2:
      return cn_check<2>(idx, deg, c, P, ST, proto);
    case 3:
      return cn_check<3>(idx, deg, c, P, ST, proto);
    case 4:
      return cn_check<4>(idx, deg, c, P, ST, proto);
    case 5:
      return cn_check<5>(idx, deg, c, P, ST, proto);
    case 6:
      return cn_check<6>(idx, deg, c, P, ST, proto);
    case 7:
      return cn_check<7>(idx, deg, c, P, ST, proto);
    case 8:
      return cn_check<8>(idx, deg, c, P, ST, proto);
  }
  return 0;
}

__device__ __forceinline__ int check_parity(const int* idx, int deg,
                                            const float* P) {
  int parity = 0;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (t < deg) parity ^= P[idx[t]] < 0.0f;
  }
  return parity;
}

// Check c's indices and degree from the device-memory tables.
__device__ __forceinline__ int load_row(const Tables& tab, int c, int m,
                                        int* idx) {
  const int deg = tab.cn_deg[c];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) idx[t] = t < deg ? tab.cn_p[t * m + c] : 0;
  return deg;
}

template <bool kOneCheck>
__global__ void __launch_bounds__(max_threads(kOneCheck))
bp_compressed_kernel(const float* __restrict__ llr,
                     uint8_t* __restrict__ bits, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ iu_out, Tables tab, int Z, int mb,
                     int nb, int E, int iters, MinSum proto, int early_stop) {
  extern __shared__ uint4 smem[];
  const int n = nb * Z;
  const int m = mb * Z;
  uint4* ST = smem;  // row state of check c = i * Z + r
  float* L = reinterpret_cast<float*>(ST + m);
  float* P = L + n;
  uint32_t* vn = reinterpret_cast<uint32_t*>(P + n);  // kOneCheck only
  uint32_t* vt = vn + n;
  const uint32_t* VN =
      kOneCheck ? vn : reinterpret_cast<const uint32_t*>(tab.vn_info);
  const uint32_t* VT =
      kOneCheck ? vt : reinterpret_cast<const uint32_t*>(tab.vn_check);
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    L[v] = llr_b[v];
    P[v] = llr_b[v];
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    ST[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  int idx[kSlots];
  int deg = 0;  // 0 for a thread past the last check
  if constexpr (kOneCheck) {
    for (int v = threadIdx.x; v < n; v += blockDim.x) vn[v] = tab.vn_info[v];
    for (int k = threadIdx.x; k < E * Z; k += blockDim.x) {
      vt[k] = tab.vn_check[k];
    }
    if (threadIdx.x < m) deg = load_row(tab, threadIdx.x, m, idx);
  }
  __syncthreads();

  int converged_at = -1;  // block-uniform
  for (int it = 1; it <= iters; ++it) {
    // ---- CN pass, single pass (+ syndrome of the pre-pass posterior) ----
    int viol = 0;
    if constexpr (kOneCheck) {
      if (deg) viol = cn_pass(idx, deg, threadIdx.x, P, ST, proto);
    } else {
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int d = load_row(tab, c, m, idx);
        viol += cn_pass(idx, d, c, P, ST, proto);
      }
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
      const uint32_t info = VN[v];
      const uint32_t* vt = VT + (info & kVnBaseMask);
      const int dc = (int)(info >> kVnBaseBits);
      float p = L[v];
      for (int t = 0; t < dc; ++t) {
        const uint32_t w = vt[t * Z];
        p = p + RowState::load(ST, (int)(w >> 3)).message((int)(w & 7u));
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
    int viol = 0;
    if constexpr (kOneCheck) {
      if (deg) viol = check_parity(idx, deg, P);
    } else {
      for (int c = threadIdx.x; c < m; c += blockDim.x) {
        const int d = load_row(tab, c, m, idx);
        viol += check_parity(idx, d, P);
      }
    }
    ok = !__syncthreads_or(viol);
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

// Bytes of dynamic shared memory one block needs: the row state (16 B a
// check), L and P, and with one check per thread (one_check != 0) the
// per-variable tables (decode/flood_plan.py::compressed_smem_bytes).
size_t ldpc_bp_compressed_smem_bytes(int Z, int mb, int nb, int E,
                                     int one_check) {
  const size_t n = (size_t)nb * Z;
  return sizeof(uint4) * (size_t)mb * Z + 2 * sizeof(float) * n +
         (one_check ? sizeof(uint32_t) * (n + (size_t)E * Z) : 0);
}

// Launches one block of `threads` threads per codeword on `stream` (a
// cudaStream_t) of the current CUDA device; the caller makes the device of
// `stream` current.  The tables, one_check and threads come from
// decode/flood_plan.py::compressed_plan.  Rows of degree above 8 (the
// sign byte), fewer threads than checks with one_check, or a thread count
// outside the form's bound or not in whole warps return
// cudaErrorInvalidValue.  Returns the cudaError_t of the attribute call or
// of the launch (cudaGetLastError); 0 means launched.  Does not
// synchronise.
int ldpc_bp_compressed(const float* llr, uint8_t* bits, uint8_t* ok,
                       int32_t* iters_used, const int32_t* cn_p,
                       const int32_t* cn_deg, const int32_t* vn_info,
                       const int32_t* vn_check, int batch, int Z, int mb,
                       int nb, int E, int max_row_deg, int one_check,
                       int threads, int iters, float alpha, float beta,
                       int early_stop, void* stream) {
  if (max_row_deg > kSlots || threads <= 0 || threads % 32 ||
      threads > max_threads(one_check) || (one_check && threads < mb * Z)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = ldpc_bp_compressed_smem_bytes(Z, mb, nb, E, one_check);
  auto kernel = one_check ? bp_compressed_kernel<true>
                          : bp_compressed_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  MinSum proto;
  proto.alpha = alpha;
  proto.beta = beta;
  kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      llr, bits, ok, iters_used, Tables{cn_p, cn_deg, vn_info, vn_check}, Z,
      mb, nb, E, iters, proto, early_stop);
  return (int)cudaGetLastError();
}

}  // extern "C"
