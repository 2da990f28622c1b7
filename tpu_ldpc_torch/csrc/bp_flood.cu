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
// Z on sublanes, static rolls).
//
// What it computes, per codeword (one thread block; grid = batch; nothing
// is padded, so no padding can leak into real codewords):
//   * L[n], P[n] float32 and R[E*Z] (float32 or bf16) live in dynamic
//     shared memory for all iterations, with a per-variable table VN[n]:
//     12n + 4EZ or 12n + 2EZ bytes (25,344 or 18,816 B for the judged
//     (1024, 512) code).  Messages never go to device memory mid-decode.
//   * R is stored in variable-aligned coordinates, its edges grouped by
//     block-column (decode/flood_plan.py): the message on edge e between
//     check r and variable z = (r + s_e) mod Z sits at R[rslot_e*Z + z].
//   * CN pass, check (i, r): q_t = sat(P[col_t*Z + z_t] - R[rslot_t*Z +
//     z_t]) over the row's slots in edge order feeds the CN update
//     (bp_common.cuh: MinSum, MinSumUnit, SumProduct, SumProductFast),
//     then R gets quantize(cn.out(t, q_t)) for the same q_t.
//   * VN pass, variable (j, z): p = L + the column's messages in
//     ascending block-row order, R[base + t*Z], then sat_post.  No
//     atomics: they would change the summation order.
//   * Quantization (NoQuant, Quant) at golden's four points: the LLRs as
//     they load, q before the CN, the CN output before R, the posterior.
//     Message storage (F32Msg, Bf16Msg): R is rounded as it is stored and
//     widened as it is read, so the CN's q and the VN sums both see the
//     rounded message, as in the Pallas kernel.
//   * Rescaled (kRescaled, with MinSumUnit): L holds the scaled channel
//     term, LLR * (1/alpha) at entry; each VN pass reads it for its sum
//     and stores it times 1/alpha for the next iteration.  The product
//     only feeds a store.
//   * Shift normalization is relabeling: the host builds the tables from
//     the effective shifts and passes the column offsets c_j in col_off
//     (null in plain coordinates); the coalesced LLR load stores into the
//     state at the rotated index and the bit store reads from it.
//   * Early termination with golden semantics (golden/decoder.py:21-25):
//     the CN pass of iteration `it` also counts violated checks of the
//     pre-pass posterior P_{it-1} (it=1 checks the channel decision);
//     __syncthreads_or turns the counts into one block-wide verdict and
//     the block exits at the first zero with iters_used = it-1.  After the
//     last iteration one standalone syndrome gives ok; iters_used = iters.
//     A block's bits come from its final P only.
//   * Built with -fmad=false: no product may be fused into an add
//     unrounded.  Sum-product calls tanhf / logf (no fast-math), which
//     round differently from PyTorch's CPU functions, so it agrees with
//     the plain version frame by frame, not bit for bit; every other mode
//     is bit-exact.
//
// What bounds it on the card.  The first design of this body was bound by
// instruction throughput: its time tracked the instruction count in
// every measurement (fixed-point's extra operations, two operations more
// per gather), while it moved about a fifth of the shared-memory
// bandwidth.  The work per edge that the algorithm needs is two gathers,
// a subtraction, a scan step, the output and its store, and one add in
// the VN sum; that design spent about three times that, on work that is
// the same every iteration or done twice.  What this design does about
// each part:
//   1. R in variable-aligned coordinates, grouped by column: the CN pass
//      reads P and R at one rotated offset z_t, the VN pass reads R at
//      base + t*Z with no wrap arithmetic at all.
//   2. One CN pass: the row's degree has a compile-time bound kMaxDeg
//      (8, 16 or 32, picked by the host from the largest row), the slot
//      loops are unrolled with `t < deg` predicates, so q_t (and for
//      exact sum-product phi(|q_t|), through add_kept / out_kept: two phi
//      per edge, not three) stays in registers between cn.add and
//      cn.out.  No second gather of P or load of R, no second
//      subtraction, saturation or phi.
//   3. Nothing that is the same in every iteration is recomputed in it:
//      each thread keeps one check for the whole decode, and its row's
//      P and R indices sit in registers from the prologue on (16 bits each
//      in one register above 8 slots); each variable's R base and column
//      degree sit in the shared VN table.  The iteration loop has no
//      integer division and loads no metadata from device memory.  The
//      block has one thread per check, in whole warps (512 for the
//      judged code).
//   4. Per-row work once per row: MinSum scales its two minima in finish,
//      and out selects between them (bp_common.cuh).
//   5. Fixed-point without a division: Quant multiplies by the exact
//      reciprocal of its power-of-two step (bp_common.cuh says why that
//      is the same float).
// With these the body takes about half the first design's time, and
// what bounds it is no longer the instruction count alone but latency
// against occupancy: at 58-64 registers a thread, two blocks of 16 warps
// fit an SM, and a build held to three blocks (at most 42 registers, so
// with spills) ran 2-4% faster on min-sum (PERF.md); this build keeps
// the judged code's instantiations free of spills.
//
// A code whose largest row exceeds 32, or that has more checks than a
// bucket's block may hold (m > 1024, or m > 512 for 32 slots), or whose
// indices do not fit 16 bits above 8 slots, runs kMaxDeg = 0: the same
// state, layout and VN pass, a block of 256 threads each taking checks
// c, c + 256, ... ((i, r) stepped without a division) in two passes over
// its row, the per-edge tables in shared memory.  For rows of at most 32
// slots under every CN update but exact sum-product, the first pass keeps
// the signs of its q in a register and the second sends from them, so
// each edge's P and R are gathered once an iteration, as in the buckets;
// longer rows and exact sum-product recompute q in the second pass.
// Several codewords per block (to fill the warps of small codes) was not
// taken: one codeword per block already has 16 warps on the judged code.
//
// K1g, bp_flood_gmem_kernel: a code whose state exceeds one block's
// shared memory (decode/flood_plan.py's SMEM_LIMIT_BYTES; NR BG1 at
// Z = 384 needs 510,832 B) runs the same body, flood_decode, with R in a
// slice of a scratch buffer in device memory, one slice a codeword, which
// the caller allocates.  The VN table is the same for every codeword, so
// the VN pass reads the plan's own copy in device memory instead of a copy
// per codeword; bucket 0's per-edge tables sit in shared memory, and the
// rows take bucket 0's two-pass form whatever the code's bucket.  Every
// policy above runs there in the same order of operations, so K1g equals
// K1 bit for bit on any code both can hold.  Two placements of L and P,
// picked by the plan from the sizes (flood_plan.gmem_placement):
//   * shared_lp: L and P in shared memory beside the row tables (143,728 B
//     at Z = 384), R alone in the slice, one block of 1024 threads an SM.
//     The P gathers of the CN pass and the VN pass's L hit shared memory,
//     and the resident codewords' R (132 x 296,448 B = 39.1 MB) fits the
//     50 MB L2, which serves R's loads and stores instead of device
//     memory.  The LLRs, read once, load evict-first (__ldcs) so they do
//     not push R out of the L2.
//   * otherwise (L and P beyond shared memory too): L, P and R in the
//     slice, 256 threads a block.  With several codewords resident on
//     each SM (0.44 MB of state each at Z = 384) the state does not stay
//     in the L2, so device-memory bandwidth bounds it.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

// The index tables of decode/flood_plan.py in device memory.  A block
// reads them once, before its first iteration.
struct Tables {
  const int32_t *vn_info, *cn_p, *cn_r, *cn_deg, *row_ptr, *e_p, *e_r,
      *e_shift;
};

constexpr int kGenericThreads = 256;
// K1g with L and P in shared memory: the most threads of its one block an
// SM (flood_plan.GMEM_SHARED_LP_THREADS is what the plan launches)
constexpr int kSharedLPThreads = 1024;
constexpr int kVnBaseBits = 17;  // vn_info = (col_deg << 17) | R base
constexpr uint32_t kVnBaseMask = (1u << kVnBaseBits) - 1;
constexpr int kPackLimit = 1 << 16;

// The most threads one block of kMaxDeg may have (flood_plan.MAX_THREADS):
// its __launch_bounds__, so 64 registers a thread at 1024, 128 at 512.
constexpr int max_threads(int max_deg) {
  return max_deg == 0 ? kGenericThreads : max_deg <= 16 ? 1024 : 512;
}

// This thread's check for the whole decode: the P and R indices of each
// slot of its row, in registers.  Above 8 slots both share one register,
// 16 bits each (the host checks n and E*Z against kPackLimit).
template <int kMaxDeg>
struct Slots {
  static constexpr bool kPacked = kMaxDeg > 8;
  int deg;  // 0 for a thread past the last check
  uint32_t a[kMaxDeg];
  uint32_t b[kPacked ? 1 : kMaxDeg];

  __device__ __forceinline__ void load(const Tables& tab, int c, int m) {
    deg = c < m ? tab.cn_deg[c] : 0;
#pragma unroll
    for (int t = 0; t < kMaxDeg; ++t) {
      const uint32_t p = t < deg ? (uint32_t)tab.cn_p[t * m + c] : 0u;
      const uint32_t r = t < deg ? (uint32_t)tab.cn_r[t * m + c] : 0u;
      if constexpr (kPacked) {
        a[t] = p | r << 16;
      } else {
        a[t] = p;
        b[t] = r;
      }
    }
  }
  __device__ __forceinline__ int p(int t) const {
    if constexpr (kPacked) return (int)(a[t] & 0xffffu);
    return (int)a[t];
  }
  __device__ __forceinline__ int r(int t) const {
    if constexpr (kPacked) return (int)(a[t] >> 16);
    return (int)b[t];
  }
};

// One CN pass over this thread's check: gathers q_t once, keeps it in
// registers from cn.add to cn.out.  Returns the parity of the pre-pass
// hard decisions (1: the check is violated).
template <class CN, class QP, class MP, int kMaxDeg>
__device__ __forceinline__ int cn_check(const Slots<kMaxDeg>& s,
                                        const float* P, typename MP::T* R,
                                        const CN& proto, const QP& quant) {
  float q[kMaxDeg];
  float kept[kMaxDeg];
  CN cn = proto;
  cn.begin();
  int parity = 0;
#pragma unroll
  for (int t = 0; t < kMaxDeg; ++t) {
    if (t < s.deg) {
      const float p = P[s.p(t)];
      q[t] = quant.sat(p - MP::load(R[s.r(t)]));
      parity ^= p < 0.0f;
      kept[t] = add_kept(cn, t, q[t]);
    }
  }
  cn.finish(s.deg);
#pragma unroll
  for (int t = 0; t < kMaxDeg; ++t) {
    if (t < s.deg) {
      R[s.r(t)] = MP::store(quant.quantize(out_kept(cn, t, q[t], kept[t])));
    }
  }
  return parity;
}

template <int kMaxDeg>
__device__ __forceinline__ int check_parity(const Slots<kMaxDeg>& s,
                                            const float* P) {
  int parity = 0;
#pragma unroll
  for (int t = 0; t < kMaxDeg; ++t) {
    if (t < s.deg) parity ^= P[s.p(t)] < 0.0f;
  }
  return parity;
}

// The most slots of a row whose q signs bucket 0 keeps in one register
// (flood_plan.SIGN_SLOTS).
constexpr int kSignSlots = 32;

// kMaxDeg = 0: this thread's checks c = threadIdx.x + k * blockDim.x with
// (i, r) stepped by (di, dr) = divmod(blockDim.x, Z), rows of any degree.
struct GenericRows {
  const int32_t *row_ptr, *e_p, *e_r, *e_shift;  // shared memory
  int i0, r0, di, dr;

  // CN pass: two passes over each row, the first feeding cn.add, the
  // second storing each slot's output.  Where out reads q only as q < 0
  // (CN::kOutFromSign) and the row has at most kSignSlots slots, the first
  // keeps q's signs in `negs` and the second stores out_neg from them,
  // loading no P and no R: one gather of each an edge, not two.  Otherwise
  // (exact sum-product, longer rows) the second recomputes q from the same
  // operands.  Returns the number of violated pre-pass checks.
  template <class CN, class QP, class MP>
  __device__ __forceinline__ int cn_pass(const float* P, typename MP::T* R,
                                         const CN& proto, const QP& quant,
                                         int Z, int m) const {
    int viol = 0;
    int i = i0;
    int r = r0;
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      const int e0 = row_ptr[i];
      const int e1 = row_ptr[i + 1];
      CN cn = proto;
      cn.begin();
      int parity = 0;
      uint32_t negs = 0;  // bit t: q_t < 0 (a longer row's bits unused)
      for (int e = e0; e < e1; ++e) {
        const int z = wrap_add(r, e_shift[e], Z);
        const float p = P[e_p[e] + z];
        const float q = quant.sat(p - MP::load(R[e_r[e] + z]));
        cn.add(e - e0, q);
        if constexpr (CN::kOutFromSign) {
          negs |= (uint32_t)(q < 0.0f) << ((e - e0) & (kSignSlots - 1));
        }
        parity ^= p < 0.0f;
      }
      cn.finish(e1 - e0);
      if constexpr (CN::kOutFromSign) {
        if (e1 - e0 <= kSignSlots) {
          send_from_signs<QP, MP>(cn, quant, R, e0, e1, r, Z, negs);
        } else {
          send_recomputed<QP, MP>(cn, quant, P, R, e0, e1, r, Z);
        }
      } else {
        send_recomputed<QP, MP>(cn, quant, P, R, e0, e1, r, Z);
      }
      viol += parity;
      step(i, r, Z);
    }
    return viol;
  }

  template <class QP, class MP, class CN>
  __device__ __forceinline__ void send_from_signs(const CN& cn,
                                                  const QP& quant,
                                                  typename MP::T* R, int e0,
                                                  int e1, int r, int Z,
                                                  uint32_t negs) const {
    for (int e = e0; e < e1; ++e, negs >>= 1) {
      const int k = e_r[e] + wrap_add(r, e_shift[e], Z);
      R[k] = MP::store(quant.quantize(cn.out_neg(e - e0, negs & 1u)));
    }
  }

  template <class QP, class MP, class CN>
  __device__ __forceinline__ void send_recomputed(const CN& cn,
                                                  const QP& quant,
                                                  const float* P,
                                                  typename MP::T* R, int e0,
                                                  int e1, int r,
                                                  int Z) const {
    for (int e = e0; e < e1; ++e) {
      const int z = wrap_add(r, e_shift[e], Z);
      const int k = e_r[e] + z;
      const float q = quant.sat(P[e_p[e] + z] - MP::load(R[k]));
      R[k] = MP::store(quant.quantize(cn.out(e - e0, q)));
    }
  }

  __device__ __forceinline__ int violations(const float* P, int Z,
                                            int m) const {
    int viol = 0;
    int i = i0;
    int r = r0;
    for (int c = threadIdx.x; c < m; c += blockDim.x) {
      int parity = 0;
      for (int e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
        parity ^= P[e_p[e] + wrap_add(r, e_shift[e], Z)] < 0.0f;
      }
      viol += parity;
      step(i, r, Z);
    }
    return viol;
  }

  __device__ __forceinline__ void step(int& i, int& r, int Z) const {
    i += di;
    r += dr;
    if (r >= Z) {
      r -= Z;
      ++i;
    }
  }
};

// One codeword's decode, run by one block: the body of both kernels.  The
// caller points L, P and R at the codeword's state, and rows at bucket 0's
// per-edge tables in shared memory.  kCopyVn (K1): the prologue copies the
// VN table into vn_copy (shared memory) and the VN pass reads it there;
// otherwise (K1g) the VN pass reads the plan's own table in device memory.
// kEvictLlr (K1g with R in the L2): the LLRs, read once, load evict-first
// so that they do not push R out of the L2.
template <class CN, class QP, class MP, bool kRescaled, int kMaxDeg,
          bool kCopyVn, bool kEvictLlr = false>
__device__ __forceinline__ void flood_decode(
    const float* __restrict__ llr, uint8_t* __restrict__ bits,
    uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
    const Tables& tab, const int32_t* __restrict__ col_off, int Z, int mb,
    int nb, int E, int iters, const CN& proto, const QP& quant,
    float inv_alpha, int early_stop, float* L, float* P, uint32_t* vn_copy,
    int32_t* rows, typename MP::T* R) {
  using Msg = typename MP::T;
  constexpr bool kGeneric = kMaxDeg == 0;
  const int n = nb * Z;
  const int m = mb * Z;
  const uint32_t* VN =
      kCopyVn ? vn_copy : reinterpret_cast<const uint32_t*>(tab.vn_info);
  const int64_t b = blockIdx.x;
  const float* llr_b = llr + b * n;

  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const float x = quant.quantize(kEvictLlr ? __ldcs(llr_b + v) : llr_b[v]);
    const int u = state_index(v, col_off, Z);
    L[u] = kRescaled ? x * inv_alpha : x;
    P[u] = x;
    if constexpr (kCopyVn) vn_copy[v] = (uint32_t)tab.vn_info[v];
  }
  for (int t = threadIdx.x; t < E * Z; t += blockDim.x) R[t] = MP::store(0.0f);
  GenericRows g{rows, rows + mb + 1, rows + mb + 1 + E, rows + mb + 1 + 2 * E,
                0, 0, 0, 0};
  Slots<kGeneric ? 1 : kMaxDeg> slots;
  if constexpr (kGeneric) {
    for (int t = threadIdx.x; t <= mb; t += blockDim.x) {
      rows[t] = tab.row_ptr[t];
    }
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      rows[mb + 1 + e] = tab.e_p[e];
      rows[mb + 1 + E + e] = tab.e_r[e];
      rows[mb + 1 + 2 * E + e] = tab.e_shift[e];
    }
    g.i0 = threadIdx.x / Z;
    g.r0 = threadIdx.x - g.i0 * Z;
    g.di = blockDim.x / Z;
    g.dr = blockDim.x - g.di * Z;
  } else {
    slots.load(tab, threadIdx.x, m);
  }
  __syncthreads();

  int converged_at = -1;  // block-uniform
  for (int it = 1; it <= iters; ++it) {
    // ---- CN pass (+ syndrome of the pre-pass posterior) ----
    int viol;
    if constexpr (kGeneric) {
      viol = g.cn_pass<CN, QP, MP>(P, R, proto, quant, Z, m);
    } else {
      viol = slots.deg ? cn_check<CN, QP, MP>(slots, P, R, proto, quant) : 0;
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
      const uint32_t info = VN[v];
      const Msg* rv = R + (info & kVnBaseMask);
      const int dc = (int)(info >> kVnBaseBits);
      float p = L[v];
      // rescaled: the next iteration's channel term; the product feeds
      // only this store
      if (kRescaled) L[v] = p * inv_alpha;
      for (int t = 0; t < dc; ++t) p = p + MP::load(rv[t * Z]);
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
    int viol;
    if constexpr (kGeneric) {
      viol = g.violations(P, Z, m);
    } else {
      viol = check_parity(slots, P);
    }
    ok = !__syncthreads_or(viol);
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

// K1: the codeword's whole state in dynamic shared memory.
template <class CN, class QP, class MP, bool kRescaled, int kMaxDeg>
__global__ void __launch_bounds__(max_threads(kMaxDeg))
bp_flood_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                Tables tab, const int32_t* __restrict__ col_off, int Z,
                int mb, int nb, int E, int iters, CN proto, QP quant,
                float inv_alpha, int early_stop) {
  using Msg = typename MP::T;
  constexpr bool kGeneric = kMaxDeg == 0;
  extern __shared__ float smem[];
  const int n = nb * Z;
  float* L = smem;
  float* P = L + n;
  uint32_t* VN = reinterpret_cast<uint32_t*>(P + n);
  int32_t* rows = reinterpret_cast<int32_t*>(VN + n);  // kGeneric only
  Msg* R = reinterpret_cast<Msg*>(kGeneric ? rows + mb + 1 + 3 * E : rows);
  flood_decode<CN, QP, MP, kRescaled, kMaxDeg, true>(
      llr, bits, ok_out, iu_out, tab, col_off, Z, mb, nb, E, iters, proto,
      quant, inv_alpha, early_stop, L, P, VN, rows, R);
}

// K1g: codeword b's R in device memory at state + b * stride.
// kSharedLP: L and P (n floats each) in shared memory, then bucket 0's
// per-edge tables; otherwise L and P at the head of the slice, R after
// them, and the per-edge tables alone in shared memory.  The VN table
// read from the plan's.
template <class CN, class QP, class MP, bool kRescaled, bool kSharedLP>
__global__ void __launch_bounds__(kSharedLP ? kSharedLPThreads
                                            : kGenericThreads)
bp_flood_gmem_kernel(const float* __restrict__ llr,
                     uint8_t* __restrict__ bits, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ iu_out, Tables tab,
                     const int32_t* __restrict__ col_off, int Z, int mb,
                     int nb, int E, int iters, CN proto, QP quant,
                     float inv_alpha, int early_stop,
                     char* __restrict__ state, size_t stride) {
  using Msg = typename MP::T;
  extern __shared__ float smem[];
  const int n = nb * Z;
  char* slice = state + blockIdx.x * stride;
  float* L = kSharedLP ? smem : reinterpret_cast<float*>(slice);
  float* P = L + n;
  int32_t* rows = reinterpret_cast<int32_t*>(kSharedLP ? P + n : smem);
  Msg* R = reinterpret_cast<Msg*>(kSharedLP ? slice
                                         : reinterpret_cast<char*>(P + n));
  flood_decode<CN, QP, MP, kRescaled, 0, false, kSharedLP>(
      llr, bits, ok_out, iu_out, tab, col_off, Z, mb, nb, E, iters, proto,
      quant, inv_alpha, early_stop, L, P, nullptr, rows, R);
}

// Bytes of dynamic shared memory one K1g block needs: bucket 0's per-edge
// tables and, with shared_lp != 0, L and P (4 B a variable each).
size_t gmem_smem_bytes(int Z, int mb, int nb, int E, int shared_lp) {
  return (shared_lp ? 2 * (size_t)nb * Z * sizeof(float) : 0) +
         (size_t)(mb + 1 + 3 * E) * sizeof(int32_t);
}

struct Args {
  const float* llr;
  uint8_t* bits;
  uint8_t* ok;
  int32_t* iters_used;
  Tables tab;
  const int32_t* col_off;
  int batch, Z, mb, nb, E, bucket, threads, iters;
  float alpha, beta, inv_alpha;
  int early_stop;
  size_t smem;
  cudaStream_t stream;
  char* state;   // K1g's scratch (null: K1), `stride` bytes a codeword
  size_t stride;
  int shared_lp;  // K1g: L and P in shared memory
};

template <class CN, class QP, class MP, bool kRescaled, int kMaxDeg>
cudaError_t launch_bucket(const Args& a, const QP& quant) {
  const int m = a.mb * a.Z;
  const int n = a.nb * a.Z;
  if (a.threads <= 0 || a.threads % 32 || a.threads > max_threads(kMaxDeg) ||
      (kMaxDeg > 0 && a.threads < m) ||
      (kMaxDeg > 8 && (n > kPackLimit || a.E * a.Z > kPackLimit))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = bp_flood_kernel<CN, QP, MP, kRescaled, kMaxDeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = a.alpha;
  proto.beta = a.beta;
  kernel<<<a.batch, a.threads, a.smem, a.stream>>>(
      a.llr, a.bits, a.ok, a.iters_used, a.tab, a.col_off, a.Z, a.mb, a.nb,
      a.E, a.iters, proto, quant, a.inv_alpha, a.early_stop);
  return cudaGetLastError();
}

// K1g: a.threads threads a codeword (at most kSharedLPThreads with L and
// P in shared memory, else kGenericThreads), bucket 0's per-edge tables in
// shared memory (a.bucket is K1's and does not apply).
template <class CN, class QP, class MP, bool kRescaled, bool kSharedLP>
cudaError_t launch_gmem(const Args& a, const QP& quant) {
  if (a.threads <= 0 || a.threads % 32 ||
      a.threads > (kSharedLP ? kSharedLPThreads : kGenericThreads)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = gmem_smem_bytes(a.Z, a.mb, a.nb, a.E, kSharedLP);
  auto kernel = bp_flood_gmem_kernel<CN, QP, MP, kRescaled, kSharedLP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = a.alpha;
  proto.beta = a.beta;
  kernel<<<a.batch, a.threads, smem, a.stream>>>(
      a.llr, a.bits, a.ok, a.iters_used, a.tab, a.col_off, a.Z, a.mb, a.nb,
      a.E, a.iters, proto, quant, a.inv_alpha, a.early_stop, a.state,
      a.stride);
  return cudaGetLastError();
}

template <class CN, class MP, bool kRescaled = false, class QP = NoQuant>
cudaError_t launch(const Args& a, QP quant = QP{}) {
  if (a.state != nullptr) {
    return a.shared_lp ? launch_gmem<CN, QP, MP, kRescaled, true>(a, quant)
                   : launch_gmem<CN, QP, MP, kRescaled, false>(a, quant);
  }
  switch (a.bucket) {
    case 8:
      return launch_bucket<CN, QP, MP, kRescaled, 8>(a, quant);
    case 16:
      return launch_bucket<CN, QP, MP, kRescaled, 16>(a, quant);
    case 32:
      return launch_bucket<CN, QP, MP, kRescaled, 32>(a, quant);
    case 0:
      return launch_bucket<CN, QP, MP, kRescaled, 0>(a, quant);
  }
  return cudaErrorInvalidValue;
}

template <class MP>
cudaError_t launch_algo(int algo, const Args& a) {
  if (algo == kMinSum) return launch<MinSum, MP>(a);
  if (algo == kSumProduct) return launch<SumProduct, MP>(a);
  if (algo == kSumProductFast) return launch<SumProductFast, MP>(a);
  return cudaErrorInvalidValue;
}

// The policies of one launch (ldpc_bp_flood's comment), then the kernel.
cudaError_t launch_mode(int algo, const Args& a, int msg_bf16, int rescaled,
                        int quantized, float step, float kmax, float lim_msg,
                        float lim_post) {
  if (quantized || rescaled) {
    if (algo != kMinSum || msg_bf16 || (quantized && rescaled)) {
      return cudaErrorInvalidValue;
    }
    if (rescaled) return launch<MinSumUnit, F32Msg, true>(a);
    Quant quant;
    if (!make_quant(step, kmax, lim_msg, lim_post, &quant)) {
      return cudaErrorInvalidValue;
    }
    return launch<MinSum, F32Msg, false>(a, quant);
  }
  return msg_bf16 ? launch_algo<Bf16Msg>(algo, a)
                  : launch_algo<F32Msg>(algo, a);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs: L, P and the VN table
// (4 B each per variable), the per-edge tables of bucket 0 (row_ptr and
// three per edge), and R in float32 or (msg_bf16 != 0) bf16.
size_t ldpc_bp_flood_smem_bytes(int Z, int mb, int nb, int E, int bucket,
                                int msg_bf16) {
  return 3 * (size_t)nb * Z * sizeof(float) +
         (bucket == 0 ? (size_t)(mb + 1 + 3 * E) * sizeof(int32_t) : 0) +
         (size_t)E * Z * (msg_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}

// Launches one block of `threads` threads per codeword on `stream` (a
// cudaStream_t) of the current CUDA device; the caller makes the device of
// `stream` current.  algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast
// (ldpc::Algo).  The tables, `bucket` (kMaxDeg: 8, 16, 32, or 0 for the
// two-pass kernel) and `threads` come from decode/flood_plan.py, built
// from the shifts the decoder runs with; col_off: the column offsets of
// shift normalization (NULL without it).  msg_bf16 != 0 stores R in
// bf16.  rescaled != 0 selects rescaled min-sum (alpha is then ignored,
// inv_alpha = fp32(1)/fp32(alpha) scales L).  quantized != 0 selects
// fixed-point min-sum on the grid `step` (a power of two) with largest
// index `kmax` and saturation limits `lim_msg` / `lim_post`.  Quantized or
// rescaled with another algo, or with bf16, both together, a step that is
// not a power of two, or a bucket / thread count the code does not fit
// return cudaErrorInvalidValue.  Returns the cudaError_t of the attribute
// call or of the launch (cudaGetLastError); 0 means launched.  Does not
// synchronise.
int ldpc_bp_flood(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                  int32_t* iters_used, const int32_t* vn_info,
                  const int32_t* cn_p, const int32_t* cn_r,
                  const int32_t* cn_deg, const int32_t* row_ptr,
                  const int32_t* e_p, const int32_t* e_r,
                  const int32_t* e_shift, const int32_t* col_off, int batch,
                  int Z, int mb, int nb, int E, int bucket, int threads,
                  int iters, float alpha, float beta, int early_stop,
                  int msg_bf16, int rescaled, float inv_alpha, int quantized,
                  float step, float kmax, float lim_msg, float lim_post,
                  void* stream) {
  const Args a{llr, bits, ok, iters_used,
               Tables{vn_info, cn_p, cn_r, cn_deg, row_ptr, e_p, e_r, e_shift},
               col_off, batch, Z, mb, nb, E, bucket, threads, iters, alpha,
               beta, inv_alpha, early_stop,
               ldpc_bp_flood_smem_bytes(Z, mb, nb, E, bucket, msg_bf16),
               (cudaStream_t)stream, nullptr, 0, 0};
  return (int)launch_mode(algo, a, msg_bf16, rescaled, quantized, step, kmax,
                          lim_msg, lim_post);
}

// Bytes of dynamic shared memory one K1g block needs (shared_lp != 0: L
// and P there too); flood_plan.flood_gmem_smem_bytes computes the same.
size_t ldpc_bp_flood_gmem_smem_bytes(int Z, int mb, int nb, int E,
                                     int shared_lp) {
  return gmem_smem_bytes(Z, mb, nb, E, shared_lp);
}

// K1g, the device-memory form of ldpc_bp_flood for a code whose state
// exceeds one block's shared memory: the same arguments and policies
// without bucket (it runs bucket 0's two-pass rows), and `shared_lp`,
// `threads` and `state`.  shared_lp != 0 keeps L and P in shared memory
// (ldpc_bp_flood_gmem_smem_bytes) on blocks of at most 1024 threads;
// shared_lp == 0 puts them in the scratch, on blocks of at most 256.
// `state` is scratch of batch * `stride` bytes in device memory that the
// kernel overwrites: codeword b's R (E * Z messages of float32, or bf16
// with msg_bf16) at state + b * stride, after its L and P (n floats each)
// where shared_lp == 0.  The caller sizes and allocates it
// (flood_plan.gmem_placement; nothing is allocated here).  A null or
// misaligned scratch, a stride below that state or not a multiple of 16,
// or a thread count that is not a positive multiple of 32 within the
// bound, is refused.  Returns as ldpc_bp_flood.
int ldpc_bp_flood_gmem(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                       int32_t* iters_used, const int32_t* vn_info,
                       const int32_t* cn_p, const int32_t* cn_r,
                       const int32_t* cn_deg, const int32_t* row_ptr,
                       const int32_t* e_p, const int32_t* e_r,
                       const int32_t* e_shift, const int32_t* col_off,
                       int batch, int Z, int mb, int nb, int E, int iters,
                       float alpha, float beta, int early_stop, int msg_bf16,
                       int rescaled, float inv_alpha, int quantized,
                       float step, float kmax, float lim_msg, float lim_post,
                       int shared_lp, int threads, void* state,
                       size_t stride, void* stream) {
  const size_t need =
      (shared_lp ? 0 : 2 * (size_t)nb * Z * sizeof(float)) +
      (size_t)E * Z * (msg_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  if (state == nullptr || (uintptr_t)state % 16 || stride % 16 ||
      stride < need) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{llr, bits, ok, iters_used,
               Tables{vn_info, cn_p, cn_r, cn_deg, row_ptr, e_p, e_r, e_shift},
               col_off, batch, Z, mb, nb, E, 0, threads, iters, alpha,
               beta, inv_alpha, early_stop, 0, (cudaStream_t)stream,
               (char*)state, stride, shared_lp != 0};
  return (int)launch_mode(algo, a, msg_bf16, rescaled, quantized, step, kmax,
                          lim_msg, lim_post);
}

}  // extern "C"
