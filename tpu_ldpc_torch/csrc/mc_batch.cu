// The Monte-Carlo batch around the decoder (sim/mc.py::BatchFn on the
// card): the encoder and the channel as one kernel before the decode, the
// six counters as one kernel after it.  NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves a batch's encode,
// channel and counters (tpu_ldpc/sim/mc.py) to XLA, which fuses them; the
// port ran them as some 30 PyTorch launches a batch (an fp64 generator
// GEMM, its casts and remainder, six element-wise channel ops, a dozen
// reductions and a stack), each reading and writing a whole (batch, n)
// tensor.  The draws (torch.randint for u, then torch.randn for the noise,
// on the batch's own generator) stay PyTorch's: they are the draw rule.
//
// Bound: bytes.  Kernel A must read u (k B a frame) and the noise (4n B)
// and write the LLRs (4n B); kernel B must read the decoded info bits and
// u (k B each a frame), `passed` (1 B) and iters_used (4 B).  The GF(2)
// product is k*m/32 word operations a frame, far below the card's integer
// rate, as long as the packed table is reused across frames.
//
// mc_encode_llr (kernel A): one block of kThreadsA threads takes kFrames
// frames.
//   1. Pack: each warp turns 32 info bits of one frame into one word with
//      __ballot_sync (bit b of word w = u[32w + b], masked by active_u
//      where shortening applies) into shared memory.
//   2. Parity: the host packs the parity map M (m, k) once, column-major
//      by words: word w of parity column r holds M[r, 32w .. 32w+31] at
//      table[w * mp + r] (zero-padded to kwp rows, a multiple of 4, and mp
//      columns, a multiple of 32).  A lane owns one parity column r and
//      walks the words four at a time: four coalesced table loads (through
//      L1 / L2: the nrlike table, 270 KB, does not fit shared memory, and
//      every block rereads it, once for kFrames frames; the next four load
//      while these are applied), then for each frame one 16-byte broadcast
//      load of the packed u and an AND / XOR into that frame's
//      accumulator.  The parity bit is the popcount's
//      low bit; __ballot_sync packs the warp's 32 columns into one word.
//      A systematic codeword is fixed by its info bits, so this is the
//      fp64 product mod 2 bit for bit.
//   3. LLRs: llr = scale * ((1 - 2c) + sigma * noise), three rounded
//      float32 operations in that order (__fmul_rn, __fadd_rn; built with
//      -fmad=false), and with RateAdapt masks llr * tx_mask + known_llr,
//      so a punctured position is +0.0: the PyTorch channel's bits.  One
//      position a thread, so a warp's loads and stores are coalesced for
//      every n; a thread walks its position's frames four at a time,
//      their loads issued before any is used.  (16-byte loads and stores,
//      four positions a thread, took 11-15% less of A's time on the H100
//      but moved no MC cell beyond its noise.)
//      The codeword bit of position j is bit j of [u | p], or bit pos[j]
//      where the pivot encoder's column map is given (null for the
//      generator encoder).
// mc_count (kernel B): one warp a frame, grid-stride over the batch.
//   The info bits of frame f are bits[f, i] (bits[f, info_cols[i]] for
//   the pivot encoder) for i < kp (kp < k: the CRC's payload), a byte a
//   lane, masked by active_u: B is ~1% of an MC cell's device time, and
//   16-byte loads moved no cell beyond its noise.
//   A warp sum gives the frame's wrong bits; lane 0 keeps bit errors,
//   frame errors, not passed, passed and wrong, and iters_used; shared
//   then global 64-bit atomics add them into acc (6,) int64, the frames
//   too.  Integer sums do not depend on their order: the counters are
//   exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 16;     // frames a block of kernel A
constexpr int kThreadsA = 256;
constexpr int kThreadsB = 256;  // eight frames at a time
constexpr int kMaxBlocksB = 512;

__device__ __forceinline__ uint32_t cw_bit(const uint32_t* us,
                                           const uint32_t* ps, int k,
                                           int s) {
  // bit s of [u | p]
  return s < k ? (us[s >> 5] >> (s & 31)) & 1u
               : (ps[(s - k) >> 5] >> ((s - k) & 31)) & 1u;
}

__device__ __forceinline__ float llr_of(uint32_t c, float z, float sigma,
                                        float scale) {
  const float x = c ? -1.0f : 1.0f;  // 1 - 2c, exact
  return __fmul_rn(scale, __fadd_rn(x, __fmul_rn(sigma, z)));
}

__global__ void __launch_bounds__(kThreadsA) mc_encode_llr_kernel(
    const uint8_t* __restrict__ u, const float* __restrict__ noise,
    float* __restrict__ llr, const uint32_t* __restrict__ table,
    const int32_t* __restrict__ pos, const uint8_t* __restrict__ active_u,
    const float* __restrict__ tx_mask, const float* __restrict__ known_llr,
    int batch, int k, int n, int kwp, int mp, float sigma, float scale) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int mw = mp >> 5;
  uint32_t* us = smem;                 // kFrames x kwp packed info bits
  uint32_t* ps = smem + kFrames * kwp;  // kFrames x mw packed parity bits
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long f0 = (long)blockIdx.x * kFrames;
  const long left = batch - f0;
  const int nf = left < kFrames ? (int)left : kFrames;

  // 1. pack u (frames past the batch and bits past k pack as 0)
  for (int idx = warp; idx < kFrames * kwp; idx += nwarps) {
    const int f = idx / kwp, i = (idx - f * kwp) * 32 + lane;
    uint32_t b = 0;
    if (f < nf && i < k) {
      b = u[(f0 + f) * k + i] != 0;
      if (active_u != nullptr) b &= active_u[i] != 0;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, b);
    if (lane == 0) us[idx] = word;
  }
  __syncthreads();

  // 2. parity columns, 32 a warp; the next four table words load while
  // the current four are applied
  const uint4* us4 = reinterpret_cast<const uint4*>(us);
  for (int g = warp; g < mw; g += nwarps) {
    const uint32_t* col = table + g * 32 + lane;
    uint32_t acc[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) acc[f] = 0;
    uint32_t t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) t[q] = __ldg(col + (long)q * mp);
    for (int w = 0; w < kwp; w += 4) {
      uint32_t nt[4] = {0, 0, 0, 0};
      if (w + 4 < kwp) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          nt[q] = __ldg(col + (long)(w + 4 + q) * mp);
      }
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const uint4 x = us4[(f * kwp + w) >> 2];
        acc[f] ^= (x.x & t[0]) ^ (x.y & t[1]) ^ (x.z & t[2]) ^ (x.w & t[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = nt[q];
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const uint32_t word = __ballot_sync(0xffffffffu, __popc(acc[f]) & 1);
      if (lane == 0) ps[f * mw + g] = word;
    }
  }
  __syncthreads();

  // 3. LLRs: a thread's position outer (its column map and masks read
  // once), frames inner, four frames' noise loads in flight at a time
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int s = pos != nullptr ? pos[j] : j;
    const float tx = tx_mask != nullptr ? tx_mask[j] : 1.0f;
    const float kn = tx_mask != nullptr ? known_llr[j] : 0.0f;
    for (int f = 0; f < nf; f += 4) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (f + g >= nf) break;
        z[g] = __ldcs(noise + (f0 + f + g) * n + j);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (f + g >= nf) break;
        float o = llr_of(cw_bit(us + (f + g) * kwp, ps + (f + g) * mw, k, s),
                         z[g], sigma, scale);
        if (tx_mask != nullptr) o = __fadd_rn(__fmul_rn(o, tx), kn);
        // plain stores: the decoder reads the LLRs next, some from L2
        llr[(f0 + f + g) * n + j] = o;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreadsB) mc_count_kernel(
    const uint8_t* __restrict__ bits, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ passed, const int32_t* __restrict__ iters,
    const int32_t* __restrict__ info_cols,
    const uint8_t* __restrict__ active_u, int batch, int n, int k, int kp,
    unsigned long long* __restrict__ acc) {
  __shared__ unsigned long long part[5];
  if (threadIdx.x < 5) part[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // lane 0's sums: bit errors, frame errors, not passed, passed and
  // wrong, iterations
  unsigned long long be = 0, fe = 0, det = 0, und = 0, its = 0;
  for (long f = (long)blockIdx.x * nwarps + warp; f < batch;
       f += (long)gridDim.x * nwarps) {
    const uint8_t* bf = bits + f * n;
    const uint8_t* uf = u + f * k;
    uint32_t wrong = 0;
    for (int i = lane; i < kp; i += 32) {
      const int col = info_cols != nullptr ? info_cols[i] : i;
      wrong += (bf[col] != uf[i]) &&
               (active_u == nullptr || active_u[i] != 0);
    }
    wrong = __reduce_add_sync(0xffffffffu, wrong);
    if (lane == 0) {
      const bool fw = wrong != 0, ok = passed[f] != 0;
      be += wrong;
      fe += fw;
      det += !ok;
      und += ok && fw;
      its += (unsigned long long)(long long)iters[f];
    }
  }
  if (lane == 0) {
    atomicAdd(&part[0], be);
    atomicAdd(&part[1], fe);
    atomicAdd(&part[2], det);
    atomicAdd(&part[3], und);
    atomicAdd(&part[4], its);
  }
  __syncthreads();
  if (threadIdx.x < 5) atomicAdd(&acc[1 + threadIdx.x], part[threadIdx.x]);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&acc[0], (unsigned long long)batch);
}

}  // namespace

extern "C" {

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// (batch, k) uint8 u and (batch, n) float32 noise -> (batch, n) float32
// LLRs.  table: (kwp, mp) uint32, kwp = ceil(ceil(k / 32) / 4) * 4 and mp
// = ceil((n - k) / 32) * 32 (sim/mc_batch.py::table_dims).  pos (n,)
// int32, active_u (k,) uint8, tx_mask and known_llr (n,) float32: each
// null where absent.
int ldpc_mc_encode_llr(const void* u, const void* noise, void* llr,
                       const void* table, const void* pos,
                       const void* active_u, const void* tx_mask,
                       const void* known_llr, int batch, int k, int n,
                       float sigma, float scale, void* stream) {
  const int kwp = ((k + 31) / 32 + 3) / 4 * 4;
  const int mp = (n - k + 31) / 32 * 32;
  const size_t smem = sizeof(uint32_t) * kFrames * (kwp + mp / 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mc_encode_llr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (batch + kFrames - 1) / kFrames;
  mc_encode_llr_kernel<<<blocks, kThreadsA, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)u, (const float*)noise, (float*)llr,
      (const uint32_t*)table, (const int32_t*)pos, (const uint8_t*)active_u,
      (const float*)tx_mask, (const float*)known_llr, batch, k, n, kwp, mp,
      sigma, scale);
  return (int)cudaGetLastError();
}

// Adds the six counters (sim/mc.py::COUNTER_FIELDS) of a decoded batch
// into acc (6,) int64: bits (batch, n) uint8, u (batch, k) uint8, passed
// (batch,) bool, iters (batch,) int32; info_cols (k,) int32 and active_u
// (k,) uint8 null where absent; errors count over info positions < kp.
int ldpc_mc_count(const void* bits, const void* u, const void* passed,
                  const void* iters, const void* info_cols,
                  const void* active_u, int batch, int n, int k, int kp,
                  void* acc, void* stream) {
  const int per_block = kThreadsB / 32;
  int blocks = (batch + per_block - 1) / per_block;
  if (blocks > kMaxBlocksB) blocks = kMaxBlocksB;
  mc_count_kernel<<<blocks, kThreadsB, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bits, (const uint8_t*)u, (const uint8_t*)passed,
      (const int32_t*)iters, (const int32_t*)info_cols,
      (const uint8_t*)active_u, batch, n, k, kp,
      (unsigned long long*)acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
