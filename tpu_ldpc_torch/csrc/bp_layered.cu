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
//     q_e   = P[col_e*Z + (r+s_e) mod Z] - R_e(r)           (edge order)
//     r_e   = quantize(CN update of the row's sat(q))    (bp_common.cuh)
//     P[..] = sat_post(q_e + r_e);  R_e(r) = r_e
//
// The quantization policy (NoQuant: identities; Quant: golden's grid)
// saturates only the CN's input: the posterior update uses the
// unsaturated q_e, then the APP saturation (the wide-APP datapath).  The
// LLRs are quantized as they load.  Under bf16 storage (Bf16Msg) q reads
// the rounded R, the posterior update takes the unrounded r_e, and only
// the store into R rounds (pallas_bp.py:612-629).  Shift normalization
// passes the effective shifts (in the plan's tables) and the column
// offsets in col_off (null in plain coordinates): the coalesced LLR load
// stores P at the rotated index and the coalesced bit store reads it from
// there, with no extra pass.
//
// Design (decode/layered_plan.py builds the tables and the block shape):
//   * A block holds `group` codewords, each with its own P[n] and R in
//     shared memory for all iterations, and one thread per check of a
//     block-row (cw_threads = Z threads a codeword): with ET off the group
//     that packs the most codewords on an SM (4 in 256 threads on the
//     judged code), with ET on, where a block runs until its slowest
//     codeword, the fewest that fill a warp.  The Z checks of a
//     block-row touch disjoint variables (each circulant is a permutation
//     and each block-column appears once per row), so running them in
//     parallel equals golden's check-by-check loop; block-rows run one
//     after another, a __syncthreads() between them.
//   * Nothing that is the same in every iteration is recomputed in it:
//     the plan gives each check the P index of each of its edges, already
//     rotated (p_idx, uint16), which the block loads into shared memory
//     once and its codewords share.  R is kept per check (R[r*r_stride +
//     e], check r's messages side by side), so a row's slot t is a fixed
//     offset from its first edge in both tables; the strides make a warp's
//     32 reads hit 32 banks.  The iteration loop has no wrap, no division
//     and no load from device memory.
//   * One pass per row: the row degree has a compile-time bound kMaxDeg
//     (8, 16 or 32), the slot loops are unrolled, and q (and exact
//     sum-product's phi(|q|), through add_kept / out_kept) stays in
//     registers from cn.add to cn.out.  In the 8-slot bucket each row-step
//     and each row of the syndrome check is dispatched on the row's exact
//     degree (a switch, uniform across the block) to straight-line code; the wider buckets predicate their slots on `t <
//     deg`, which costs a branch and register moves per slot and keeps
//     the row's loads from issuing together.
//   * Early termination with golden semantics, per codeword: a standalone
//     syndrome before the first sweep (iters_used 0) and one after each
//     sweep `it` (iters_used = it).  A sweep's posterior changes row by
//     row, so the check is its own pass after the sweep, over the same
//     precomputed indices.  Each codeword's verdict goes through a flag in
//     shared memory (two, used in turn); a converged codeword stops
//     updating, and the block ends when all its codewords have.  With ET
//     off one syndrome after the last sweep gives ok.
//   * Codewords past the batch in the last block (and threads past the
//     last codeword) never load, compute or store: nothing padded reaches
//     a real codeword.
//   * Built with -fmad=false; every mode but exact sum-product is
//     bit-exact with the plain version, sum-product agrees frame by frame
//     (tanhf / logf round differently from PyTorch's CPU functions).
//
// A code whose rows exceed 32, whose Z exceeds kMaxThreads, or whose index
// table does not fit beside one codeword's state runs kMaxDeg = 0: the same
// state and schedule, two passes over each row of any degree (the second
// recomputes q from the same operands: P[v] is written only by this
// thread, after it is read), the indices computed from per-edge offsets
// and shifts in shared memory, and each thread walking checks r, r +
// cw_threads, ... when Z exceeds the block.
//
// What bounds it on the card: instruction issue and the serial chain of
// block-rows (mb dependent row-steps per iteration, each a scan of about
// E/mb edges behind a barrier), against the residency shared memory allows
// (P and R of each codeword, about 17 KB on the judged code: 12 codewords
// an SM).  The design spends its instructions on the scan itself and keeps
// each row's loads independent of one another, so the warps of the
// resident codewords hide each other's shared-memory latency.

#include "bp_common.cuh"

namespace {

using namespace ldpc;

constexpr int kMaxThreads = 256;  // decode/layered_plan.py MAX_BLOCK_THREADS

__host__ __device__ constexpr size_t align16(size_t nbytes) {
  return (nbytes + 15) / 16 * 16;
}

// The plan's tables in device memory; a block copies them into shared
// memory before its first iteration.
struct Tables {
  const uint16_t* p_idx;   // (Z, idx_stride), kMaxDeg > 0
  const int32_t* row_ptr;  // (mb + 1)
  const int32_t* e_p;      // (E) col_e * Z, kMaxDeg = 0
  const int32_t* e_shift;  // (E) effective shifts, kMaxDeg = 0
};

struct Shape {
  int Z, mb, nb, E, group, cw_threads, idx_stride, r_stride, batch, iters;
};

// The shared-memory layout of one block (ldpc_bp_layered_smem_bytes and
// decode/layered_plan.py::smem_bytes add up the same).
struct Layout {
  size_t table, rows, p, per_cw, flags, total;

  __host__ __device__ Layout(const Shape& s, int max_deg, size_t msg_bytes) {
    table = max_deg ? align16((size_t)s.Z * s.idx_stride * sizeof(uint16_t))
                    : align16((size_t)2 * s.E * sizeof(int32_t));
    rows = align16((size_t)(s.mb + 1) * sizeof(int32_t));
    p = align16((size_t)s.nb * s.Z * sizeof(float));
    per_cw = p + align16((size_t)s.Z * s.r_stride * msg_bytes);
    flags = table + rows + s.group * per_cw;
    total = flags + 2 * (size_t)s.group * sizeof(int);
  }
};

// Check r's P index of slot t of the row starting at edge e0.
template <int kMaxDeg>
struct Index {
  const uint16_t* tab;  // kMaxDeg > 0: the shared p_idx table
  const int32_t *ep, *es;  // kMaxDeg = 0: per-edge offsets and shifts
  int stride, Z;

  __device__ __forceinline__ int operator()(int r, int e0, int t) const {
    if constexpr (kMaxDeg > 0) {
      return tab[r * stride + e0 + t];
    } else {
      return ep[e0 + t] + wrap_add(r, es[e0 + t], Z);
    }
  }
};

// The parity of check r's row under hard(P); kDeg as in
// update_row_one_pass.
template <int kMaxDeg, int kDeg>
__device__ __forceinline__ int row_parity(const Index<kMaxDeg>& ix, int r,
                                          int e0, int deg, const float* P) {
  constexpr int kSlots = kDeg ? kDeg : kMaxDeg;
  int parity = 0;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (kDeg || t < deg) parity ^= P[ix(r, e0, t)] < 0.0f;
  }
  return parity;
}

// 1 if any check of this thread (r = r0, r0 + cw_threads, ...) is
// violated by hard(P).
template <int kMaxDeg>
__device__ __forceinline__ int violated(const Index<kMaxDeg>& ix,
                                        const int32_t* rows, const float* P,
                                        int r0, const Shape& s) {
  for (int r = r0; r < s.Z; r += s.cw_threads) {
    for (int i = 0; i < s.mb; ++i) {
      const int e0 = rows[i];
      const int deg = rows[i + 1] - e0;
      int parity = 0;
      if constexpr (kMaxDeg == 8) {
        switch (deg) {  // uniform across the block: straight-line code
          case 1: parity = row_parity<8, 1>(ix, r, e0, deg, P); break;
          case 2: parity = row_parity<8, 2>(ix, r, e0, deg, P); break;
          case 3: parity = row_parity<8, 3>(ix, r, e0, deg, P); break;
          case 4: parity = row_parity<8, 4>(ix, r, e0, deg, P); break;
          case 5: parity = row_parity<8, 5>(ix, r, e0, deg, P); break;
          case 6: parity = row_parity<8, 6>(ix, r, e0, deg, P); break;
          case 7: parity = row_parity<8, 7>(ix, r, e0, deg, P); break;
          case 8: parity = row_parity<8, 8>(ix, r, e0, deg, P); break;
        }
      } else if constexpr (kMaxDeg > 0) {
        parity = row_parity<kMaxDeg, 0>(ix, r, e0, deg, P);
      } else {
        for (int t = 0; t < deg; ++t) parity ^= P[ix(r, e0, t)] < 0.0f;
      }
      if (parity) return 1;
    }
  }
  return 0;
}

// One pass over the row of check r: q = P - R over its slots into the CN
// update, then the posterior and the new messages.  kDeg > 0: the row has
// exactly kDeg slots (straight-line code); kDeg = 0: up to kMaxDeg slots
// under `t < deg` predicates.
template <class CN, class QP, class MP, int kMaxDeg, int kDeg>
__device__ __forceinline__ void update_row_one_pass(
    const Index<kMaxDeg>& ix, int r, int e0, int deg, float* P,
    typename MP::T* Rr, const CN& proto, const QP& quant) {
  constexpr int kSlots = kDeg ? kDeg : kMaxDeg;
  CN cn = proto;
  cn.begin();
  int v[kSlots];
  float q[kSlots];
  float kept[kSlots];
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (kDeg || t < deg) {
      v[t] = ix(r, e0, t);
      q[t] = P[v[t]] - MP::load(Rr[t]);
      kept[t] = add_kept(cn, t, quant.sat(q[t]));
    }
  }
  cn.finish(kDeg ? kDeg : deg);
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (kDeg || t < deg) {
      const float r_new =
          quant.quantize(out_kept(cn, t, quant.sat(q[t]), kept[t]));
      P[v[t]] = quant.sat_post(q[t] + r_new);  // the unrounded message
      Rr[t] = MP::store(r_new);
    }
  }
}

// One row-step of check r.  The 8-slot bucket (the judged code's)
// dispatches on the row's degree, uniform across the block, to
// straight-line code; the wider buckets predicate their slots; kMaxDeg = 0
// runs two passes over a row of any degree.
template <class CN, class QP, class MP, int kMaxDeg>
__device__ __forceinline__ void update_row(const Index<kMaxDeg>& ix, int r,
                                           int e0, int deg, float* P,
                                           typename MP::T* Rr,
                                           const CN& proto,
                                           const QP& quant) {
  if constexpr (kMaxDeg == 8) {
    switch (deg) {  // uniform across the block: straight-line code
      case 1:
        return update_row_one_pass<CN, QP, MP, 8, 1>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 2:
        return update_row_one_pass<CN, QP, MP, 8, 2>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 3:
        return update_row_one_pass<CN, QP, MP, 8, 3>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 4:
        return update_row_one_pass<CN, QP, MP, 8, 4>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 5:
        return update_row_one_pass<CN, QP, MP, 8, 5>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 6:
        return update_row_one_pass<CN, QP, MP, 8, 6>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 7:
        return update_row_one_pass<CN, QP, MP, 8, 7>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
      case 8:
        return update_row_one_pass<CN, QP, MP, 8, 8>(ix, r, e0, deg, P, Rr,
                                                      proto, quant);
    }
  } else if constexpr (kMaxDeg > 0) {
    update_row_one_pass<CN, QP, MP, kMaxDeg, 0>(ix, r, e0, deg, P, Rr, proto,
                                               quant);
  } else {
    CN cn = proto;
    cn.begin();
    for (int t = 0; t < deg; ++t) {
      cn.add(t, quant.sat(P[ix(r, e0, t)] - MP::load(Rr[t])));
    }
    cn.finish(deg);
    for (int t = 0; t < deg; ++t) {
      const int v = ix(r, e0, t);
      const float q = P[v] - MP::load(Rr[t]);
      const float r_new = quant.quantize(cn.out(t, quant.sat(q)));
      P[v] = quant.sat_post(q + r_new);
      Rr[t] = MP::store(r_new);
    }
  }
}

template <class CN, class QP, class MP, int kMaxDeg>
__global__ void __launch_bounds__(kMaxThreads)
bp_layered_kernel(const float* __restrict__ llr, uint8_t* __restrict__ bits,
                  uint8_t* __restrict__ ok_out, int32_t* __restrict__ iu_out,
                  Tables tab, const int32_t* __restrict__ col_off, Shape s,
                  CN proto, QP quant, int early_stop) {
  using Msg = typename MP::T;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout lay(s, kMaxDeg, sizeof(Msg));
  const int Z = s.Z;
  const int n = s.nb * Z;
  const int G = s.group;
  const int g = threadIdx.x / s.cw_threads;
  const int r0 = threadIdx.x - g * s.cw_threads;
  const int64_t b = (int64_t)blockIdx.x * G + g;
  const bool present = g < G && b < s.batch;
  int32_t* rows = reinterpret_cast<int32_t*>(smem + lay.table);
  float* P = reinterpret_cast<float*>(smem + lay.table + lay.rows +
                                      (present ? g : 0) * lay.per_cw);
  Msg* R = reinterpret_cast<Msg*>(reinterpret_cast<char*>(P) + lay.p);
  int* flags = reinterpret_cast<int*>(smem + lay.flags);  // [2][G]
  Index<kMaxDeg> ix{reinterpret_cast<const uint16_t*>(smem),
                    reinterpret_cast<const int32_t*>(smem),
                    reinterpret_cast<const int32_t*>(smem) + s.E,
                    s.idx_stride, Z};

  if constexpr (kMaxDeg > 0) {  // the index table, as 32-bit words
    const int words = Z * s.idx_stride / 2;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(tab.p_idx);
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    for (int k = threadIdx.x; k < words; k += blockDim.x) dst[k] = src[k];
  } else {
    int32_t* dst = reinterpret_cast<int32_t*>(smem);
    for (int e = threadIdx.x; e < s.E; e += blockDim.x) {
      dst[e] = tab.e_p[e];
      dst[s.E + e] = tab.e_shift[e];
    }
  }
  for (int i = threadIdx.x; i <= s.mb; i += blockDim.x) {
    rows[i] = tab.row_ptr[i];
  }
  if (present) {
    const float* llr_b = llr + b * n;
    for (int j = 0; j < s.nb; ++j) {
      const int off = col_off ? col_off[j] : 0;
      for (int z = r0; z < Z; z += s.cw_threads) {
        P[j * Z + wrap_sub(z, off, Z)] = quant.quantize(llr_b[j * Z + z]);
      }
    }
    for (int r = r0; r < Z; r += s.cw_threads) {
      for (int e = 0; e < s.E; ++e) R[r * s.r_stride + e] = MP::store(0.0f);
    }
    if (r0 == 0) {
      flags[g] = 0;
      flags[G + g] = 0;
    }
  }
  __syncthreads();

  // per codeword: every thread of a codeword holds the same verdicts
  bool converged = false;
  int iters_used = s.iters;
  int buf = 0;  // the flag of this check; the other is cleared for the next
  if (early_stop) {
    if (present && violated(ix, rows, P, r0, s)) flags[g] = 1;
    __syncthreads();
    if (present && !flags[g]) {
      converged = true;
      iters_used = 0;
    }
    buf = 1;
  }
  for (int it = 1; it <= s.iters; ++it) {
    const bool live = present && !converged;
    if (!__syncthreads_or(live)) break;  // every codeword of the block done
    for (int i = 0; i < s.mb; ++i) {
      if (live) {
        const int e0 = rows[i];
        const int deg = rows[i + 1] - e0;
        for (int r = r0; r < Z; r += s.cw_threads) {
          update_row<CN, QP, MP, kMaxDeg>(ix, r, e0, deg, P,
                                          R + r * s.r_stride + e0, proto,
                                          quant);
        }
      }
      __syncthreads();
    }
    if (early_stop) {
      if (live) {
        // the other flag was last read before this sweep's barriers
        if (r0 == 0) flags[(buf ^ 1) * G + g] = 0;
        if (violated(ix, rows, P, r0, s)) flags[buf * G + g] = 1;
      }
      __syncthreads();
      if (live && !flags[buf * G + g]) {
        converged = true;
        iters_used = it;
      }
      buf ^= 1;
    }
  }

  int ok;
  if (early_stop) {
    ok = converged;  // else the check after the last sweep failed
  } else {
    if (present && violated(ix, rows, P, r0, s)) flags[g] = 1;
    __syncthreads();
    ok = present && !flags[g];
  }
  if (present) {
    uint8_t* bits_b = bits + b * n;
    for (int j = 0; j < s.nb; ++j) {
      const int off = col_off ? col_off[j] : 0;
      for (int z = r0; z < Z; z += s.cw_threads) {
        bits_b[j * Z + z] = P[j * Z + wrap_sub(z, off, Z)] < 0.0f;
      }
    }
    if (r0 == 0) {
      ok_out[b] = (uint8_t)ok;
      iu_out[b] = iters_used;
    }
  }
}

struct Args {
  const float* llr;
  uint8_t* bits;
  uint8_t* ok;
  int32_t* iters_used;
  Tables tab;
  const int32_t* col_off;
  Shape shape;
  int bucket, threads;
  float alpha, beta;
  int early_stop;
  cudaStream_t stream;
};

template <class CN, class QP, class MP, int kMaxDeg>
cudaError_t launch_bucket(const Args& a, const QP& quant) {
  const Shape& s = a.shape;
  const size_t smem = Layout(s, kMaxDeg, sizeof(typename MP::T)).total;
  if (a.threads <= 0 || a.threads % 32 || a.threads > kMaxThreads ||
      s.group < 1 || s.cw_threads < 1 || s.cw_threads > s.Z ||
      a.threads < s.group * s.cw_threads ||
      (kMaxDeg > 0 && s.cw_threads != s.Z) || s.r_stride < s.E ||
      (kMaxDeg > 0 && (s.idx_stride < s.E || s.idx_stride % 2 ||
                       s.nb * s.Z > 1 << 16))) {
    return cudaErrorInvalidValue;
  }
  auto kernel = bp_layered_kernel<CN, QP, MP, kMaxDeg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  CN proto;
  proto.alpha = a.alpha;
  proto.beta = a.beta;
  const int blocks = (s.batch + s.group - 1) / s.group;
  kernel<<<blocks, a.threads, smem, a.stream>>>(
      a.llr, a.bits, a.ok, a.iters_used, a.tab, a.col_off, s, proto, quant,
      a.early_stop);
  return cudaGetLastError();
}

template <class CN, class MP, class QP = NoQuant>
cudaError_t launch(const Args& a, QP quant = QP{}) {
  switch (a.bucket) {
    case 8:
      return launch_bucket<CN, QP, MP, 8>(a, quant);
    case 16:
      return launch_bucket<CN, QP, MP, 16>(a, quant);
    case 32:
      return launch_bucket<CN, QP, MP, 32>(a, quant);
    case 0:
      return launch_bucket<CN, QP, MP, 0>(a, quant);
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the index table or, for
// bucket 0, the per-edge offsets and shifts; the row pointer; P and R of
// each of `group` codewords, R in float32 or (msg_bf16 != 0) bf16; two
// flags per codeword).
size_t ldpc_bp_layered_smem_bytes(int Z, int mb, int nb, int E, int bucket,
                                  int group, int idx_stride, int r_stride,
                                  int msg_bf16) {
  const Shape s{Z, mb, nb, E, group, 0, idx_stride, r_stride, 0, 0};
  return Layout(s, bucket,
                msg_bf16 ? sizeof(__nv_bfloat16) : sizeof(float)).total;
}

// Launches ceil(batch / group) blocks of `threads` threads on `stream` (a
// cudaStream_t) of the current CUDA device; the caller makes the device of
// `stream` current.  algo: 0 min-sum, 1 sum-product, 2 sumproduct-fast
// (ldpc::Algo).  The tables, bucket (kMaxDeg: 8, 16, 32, or 0 for the
// two-pass form), group, cw_threads, threads and the two strides come
// from decode/layered_plan.py, built from the shifts the decoder runs
// with; col_off: the column offsets of shift normalization (NULL
// without it).  msg_bf16 != 0 stores R in bf16.  quantized != 0 selects
// fixed-point min-sum on the grid `step` (a power of two) with largest
// index `kmax` and saturation limits `lim_msg` / `lim_post`; with another
// algo, with bf16, with a step that is not a power of two, or with a
// block shape the code does not fit it returns cudaErrorInvalidValue.
// Returns the cudaError_t of the attribute call or of the launch
// (cudaGetLastError); 0 means launched.  Does not synchronise.
int ldpc_bp_layered(int algo, const float* llr, uint8_t* bits, uint8_t* ok,
                    int32_t* iters_used, const uint16_t* p_idx,
                    const int32_t* row_ptr, const int32_t* e_p,
                    const int32_t* e_shift, const int32_t* col_off,
                    int batch, int Z, int mb, int nb, int E, int bucket,
                    int group, int cw_threads, int threads, int idx_stride,
                    int r_stride, int iters, float alpha, float beta,
                    int early_stop, int msg_bf16, int quantized, float step,
                    float kmax, float lim_msg, float lim_post, void* stream) {
  const Args a{llr, bits, ok, iters_used,
               Tables{p_idx, row_ptr, e_p, e_shift}, col_off,
               Shape{Z, mb, nb, E, group, cw_threads, idx_stride, r_stride,
                     batch, iters},
               bucket, threads, alpha, beta, early_stop,
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
