// SwiftKV single-pass decode attention for Hopper (sm_90a): the GQA form,
// the G query heads of a KV head on mma.sync tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/swiftkv_decode/kernel.py:
// swiftkv_decode_pallas (body _kernel), for the shapes that
// kernels/swiftkv_decode/ops.py::kernel_form gives it: a bf16 q, a bf16
// cache or an int8 cache with f32 or bf16 scales, the native exponential,
// 2 <= G <= 8 and D a multiple of 16 up to 256, in the linear, windowed
// and ring forms. Everything else runs swiftkv_decode.cu's fold. Same
// function: one query token per (row, query head), the cache in its native
// [B, S, Hkv, D] layout, folded in ONE pass with the running (mu, Z, Y),
// one deferred division, an exact 0 where Z = 0. The ring is read in
// position space as in swiftkv_decode.cu: the window's positions [lo, len)
// cut into tiles aligned to position 0, position t at slot t mod S, so the
// ring form folds the same tiles in the same order as the linear form on a
// cache that holds the same positions and the two agree bit for bit.
//
// The pooled form (entries != null): k, v are a source-KV pool [E, S,
// Hkv, D] and row b reads entry e = entries[b] (loaded beside lengths[b]):
// its cache base and scale planes at e in place of b, q and out row b's,
// so it is bit for bit the read of the gathered copy k[entries], as in
// swiftkv_decode.cu.
//
// Bound on an H100: bytes. Each (row, KV head) reads its window's K and V
// once: at h2o-danube-1.8b's decode step (B 8, Hkv 8, G 4, D 80, window
// 4096, bf16) 84 MB, 25 us at 3.35 TB/s; the arithmetic, ~4 G D
// operations per position, is ~1 operation per byte against the ~295 at
// which the tensor cores would bound. What held swiftkv_decode.cu's fold
// back at that shape, and what this form does about each:
//
// 1. Lane groups and shuffles. The fold gives each position to a group of
//    pow2ceil(D / 8) lanes (16 at D 80, of which 10 work), reduces every
//    dot product by shuffles and has each lane of the group compute the
//    same exponentials. Here a warp's 16 positions of a step are the N
//    dimension of S = Q K^T and then the K dimension of P V, both on
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate). The G heads are the rows
//    of A, padded to 16 (rows G..15 are zero; their C rows are dropped).
//    The C fragment of S is the A fragment of P, so P never touches shared
//    memory; each (head, position) exponential is computed once, by one
//    lane; the max over a step takes two quad shuffles. K comes from shared
//    memory by ldmatrix, V by ldmatrix.trans (the cache is position-major).
//    P goes into P V in two bf16 parts, high and low (two products), so
//    the weights keep ~16 bits: the output is as close to the f32 softmax
//    as the fold's, and a bf16 output is rounded once, from f32-class sums.
// 2. Too few bytes in flight. Each warp keeps kStages stages of 16 rows of
//    K and V, filled by 16-byte cp.async one row at a time (a tile that
//    straddles the ring's wrap costs nothing; rows outside [lo, len) are
//    zero-filled without a read, so a masked weight never meets a NaN).
//    At D 80 a CTA holds 2 stages ahead x 4 warps x 5 KB, ~40 KB in
//    flight, and reaches 85-90% of a plain torch.sum's rate over the same
//    bytes: measured on an H100, more in flight (more CTAs per SM, deeper
//    stages) only lengthens the wait. The split policy (ops.py::
//    split_count, shared with swiftkv_decode.cu) counts the window's
//    tiles, of min(S, window) positions, so a ring and its linear twin get
//    the same n_split, and models the launch on what the card holds of this
//    instance (swiftkv_decode_mma_occupancy below): its waves of clusters,
//    whose CTAs must fit in one GPC, and the tile bytes the resident CTAs
//    keep in flight, against ~2.4 MB that reach the memory's rate.
// 3. Bank conflicts. A 160-byte row (D 80) puts two of ldmatrix's eight
//    16-byte rows in one bank group. Rows are padded to an odd number of
//    16-byte units (176 bytes at D 80 bf16), so every ldmatrix and every
//    2-byte load below is conflict-free.
// 4. int8 caches. Codes are exact in bf16 and are widened in registers:
//    K by ldmatrix of byte pairs, whose d order the Q fragment follows
//    (the dot product does not care); V by 2-byte loads of two adjacent d
//    of four positions, each n-tile of the output a permuted run of d that
//    the store undoes. As in the fold, the k scale multiplies the score and
//    the v scale the position's weight; they ride the stages by cp.async
//    when S % 16 == 0, else are read in place.
//
// Scores live in log2 units (scale x log2 e folded in), so every
// exponential is one ex2.approx. The partial states are merged as in
// swiftkv_decode.cu: a warp's quad sums its Z, the CTA's four warps merge
// in warp order through shared memory, the n_split CTAs of a (row, KV
// head) form one thread-block cluster and rank 0 merges their states from
// distributed shared memory in split order and divides once. No float
// atomics and no second launch: two launches on the same inputs are
// bitwise equal.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // positions a warp folds per step
constexpr int kTile = kWarps * kRows;         // 64: positions per CTA step
constexpr int kStages = 3;                    // ring depth per warp (2, 4: no faster)
constexpr int kMaxSplit = 8;                  // CTAs per cluster (portable limit)
constexpr int kMaxG = 8;                      // query heads per KV head: rows 0-7 of A
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF
constexpr float kLog2E = 1.4426950408889634f;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `width` bytes; bytes == 0 zero-fills the destination and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d += A B on one m16n8k16 tile, bf16 in, f32 accumulate; only A's rows
// 0-7 (the query heads) are live: A's rows 8-15 are zero and C's rows
// 8-15 dropped. a0: row lane/4, k 2c, 2c+1; a2: the same row, k 2c+8,
// 2c+9 (c = lane % 4). b0, b1: n lane/4, k 2c, 2c+1 and 2c+8, 2c+9.
// d0, d1: row lane/4, n 2c, 2c+1.
__device__ __forceinline__ void mma(float& d0, float& d1, uint32_t a0, uint32_t a2, uint32_t b0,
                                    uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %10, %11};\n"
      : "+f"(d0), "+f"(d1), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bytes i and j of u = codes ^ 0x80808080 (four int8 codes, sign bits
// flipped) as a bf16 pair, byte i low: 2^23 + (code + 128) built from
// exponent bits, less 2^23 + 128, exact.
__device__ __forceinline__ uint32_t codes_bf16(uint32_t u, int i, int j) {
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)),
                             8388736.f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)),
                             8388736.f);
  return pack_bf16(lo, hi);
}

// state_merge of (mu, z, y) with (mu_b, z_b, y_b), in place, log2 units
__device__ __forceinline__ void merge(float& mu, float& z, float& y, float mu_b, float z_b,
                                      float y_b) {
  const float m = fmaxf(mu, mu_b);
  const float ea = ex2(mu - m);
  const float eb = ex2(mu_b - m);
  z = __fmaf_rn(ea, z, __fmul_rn(eb, z_b));
  y = __fmaf_rn(ea, y, __fmul_rn(eb, y_b));
  mu = m;
}

// a row of K or V in shared memory: its bytes padded to an odd number of
// 16-byte units, so the eight rows of an ldmatrix lie in eight bank groups
__host__ __device__ constexpr int row_pitch(int row_bytes) {
  return (row_bytes / 16) % 2 ? row_bytes : row_bytes + 16;
}

// Shared memory (dynamic): during the loop, warp w's ring of kStages
// stages, each K rows [kRows][pitch] and V rows [kRows][pitch] in the
// cache's type and, for int8, the rows' k and v scales [kRows] in theirs;
// after it, the same bytes hold the warps' states for the CTA merge, y
// [kWarps][G][D], mu [kWarps][G], z [kWarps][G], then the CTA's state for
// the cluster merge, y [G][D], (mu, z) [G][2] (all f32).
template <typename KT, typename ST>
__host__ __device__ constexpr int stage_bytes(int D) {
  return 2 * kRows * row_pitch(D * static_cast<int>(sizeof(KT))) +
         (std::is_same<KT, int8_t>::value ? 2 * kRows * static_cast<int>(sizeof(ST)) : 0);
}
template <typename KT, typename ST>
__host__ __device__ constexpr size_t ring_bytes(int D) {
  return static_cast<size_t>(kWarps) * kStages * stage_bytes<KT, ST>(D);
}
__host__ __device__ constexpr size_t merge_bytes(int G, int D) {
  return static_cast<size_t>(kWarps + 1) * G * (D + 2) * sizeof(float);
}

// q, out: [B, Hkv, G, D] bf16; k, v: [B, S, Hkv, D]; lengths: [B];
// k_scale, v_scale: [B, Hkv, S] for an int8 cache, else null. Launched with
// clusters of (1, n_split, 1) CTAs. kD >= D bounds D at compile time (the
// fragments' registers); D % 16 == 0. scale_log2: the softmax scale times
// log2 e. copy16: 16-byte copies (else 8: an int8 cache aligned to 8 bytes
// only). scales_async: the int8 scales ride the stages (S % 16 == 0,
// 16-byte aligned planes), else they are read in place.
template <typename KT, typename ST, int kD>
__global__ void __launch_bounds__(kThreads)
swiftkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                   const KT* __restrict__ v, const int* __restrict__ lengths,
                   const int* __restrict__ entries,
                   const ST* __restrict__ k_scale, const ST* __restrict__ v_scale,
                   __nv_bfloat16* __restrict__ out, int S, int Hkv, int G, int D, int window,
                   int is_ring, float scale_log2, int n_split, int copy16, int scales_async) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kKS = kD / 16;                // k-steps of S = Q K^T, 16 d each
  constexpr int kND = kD / 8;                 // n-tiles of P V, 8 d each
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x;                  // b * Hkv + h
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;                   // this lane's row of A and C: a query head
  const int c = lane & 3;
  const int nks = D / 16;

  // Q as A fragments (a0, a2 of each k-step), rows >= G zero. The bf16
  // form takes d 2c, 2c+1 and 2c+8, 2c+9 of each 16; the int8 form d 4c ..
  // 4c+3, the order in which ldmatrix hands it K's byte pairs.
  uint32_t qa[kKS][2];
  const __nv_bfloat16* qrow = q + (static_cast<size_t>(bh) * G + gq) * D;
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (ks < nks && gq < G) {
      if (kQuant) {
        const uint2 w = *reinterpret_cast<const uint2*>(qrow + 16 * ks + 4 * c);
        qa[ks][0] = w.x;
        qa[ks][1] = w.y;
      } else {
        qa[ks][0] = *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 2 * c);
        qa[ks][1] = *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8 + 2 * c);
      }
    }
  }

  // this CTA's chunk: tiles [tile0, tile0 + n_steps) of [lo, len), aligned
  // to absolute position 0; a ring's positions are unbounded, its window
  // at most S
  const int len_b = lengths[b];
  const int e = entries ? entries[b] : b;     // the pool entry this row reads
  const int len = is_ring ? max(0, len_b) : max(0, min(len_b, S));
  const int span = is_ring ? min(window, S) : window;
  const int lo = span > 0 ? max(0, len - span) : 0;
  const int first = lo / kTile;
  const int n_tiles = len > lo ? (len + kTile - 1) / kTile - first : 0;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int tile0 = first + split * per;
  const int n_steps = max(0, min(first + n_tiles, tile0 + per) - tile0);

  const int row_bytes = D * static_cast<int>(sizeof(KT));
  const int pitch = row_pitch(row_bytes);
  const int kv_bytes = kRows * pitch;         // the K (or V) rows of a stage
  const int sbytes = stage_bytes<KT, ST>(D);
  unsigned char* ring = smem + static_cast<size_t>(warp) * kStages * sbytes;
  const uint32_t ring_s = smem_u32(ring);
  const size_t pos_stride = static_cast<size_t>(Hkv) * row_bytes;   // bytes
  const size_t head_off = static_cast<size_t>(e) * S * pos_stride +
                          static_cast<size_t>(h) * row_bytes;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + head_off;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + head_off;
  const size_t plane = (static_cast<size_t>(e) * Hkv + h) * S;   // scale plane
  const ST* ksb = kQuant ? k_scale + plane : nullptr;
  const ST* vsb = kQuant ? v_scale + plane : nullptr;

  // copies: a row is per_row copies of `width` bytes; lane takes copy
  // lane, lane + 32, ... of a step's kRows x per_row (per_row <= 32)
  const int width = copy16 ? 16 : 8;
  const int per_row = row_bytes / width;
  const int r_lane = lane / per_row;
  const int c_lane = lane - r_lane * per_row;
  const int r_step = 32 / per_row;
  const int c_step = 32 - r_step * per_row;
  // the slot of a warp's first row t0 of a step (t0 >= 0; below S in the
  // linear form); row r of the step lies in slot wrap(slot(t0) + r)
  auto slot = [&](int t0) { return is_ring ? t0 % S : t0; };
  auto wrap = [&](int sl) { return sl >= S ? sl % S : sl; };

  // copy this warp's rows of step j into stage j % kStages, rows outside
  // [lo, len) zero-filled; always commit, so group j is step j's copies
  auto fetch = [&](int j) {
    if (j < n_steps) {
      const int t0 = (tile0 + j) * kTile + warp * kRows;
      const int s0 = slot(t0);
      const uint32_t dst = ring_s + (j % kStages) * sbytes;
      int r = r_lane, col = c_lane;
      while (r < kRows) {
        const bool ok = t0 + r >= lo && t0 + r < len;
        const size_t src = ok ? static_cast<size_t>(wrap(s0 + r)) * pos_stride + col * width : 0;
        const uint32_t d = dst + r * pitch + col * width;
        if (copy16) {
          cp_async16(d, kb + src, ok ? 16 : 0);
          cp_async16(d + kv_bytes, vb + src, ok ? 16 : 0);
        } else {
          cp_async8(d, kb + src, ok ? 8 : 0);
          cp_async8(d + kv_bytes, vb + src, ok ? 8 : 0);
        }
        r += r_step;
        col += c_step;
        if (col >= per_row) {
          col -= per_row;
          ++r;
        }
      }
      if (kQuant && scales_async) {
        // the 16 rows' scales: t0 % 16 == 0 and S % 16 == 0 keep them in
        // this (row, head)'s plane, in one run of slots on a ring
        constexpr int n16 = kRows * static_cast<int>(sizeof(ST)) / 16;
        if (lane < 2 * n16) {
          const int which = lane / n16;
          const int part = lane - which * n16;
          const unsigned char* sp = reinterpret_cast<const unsigned char*>((which ? vsb : ksb) + s0);
          cp_async16(dst + 2 * kv_bytes + which * kRows * static_cast<int>(sizeof(ST)) + part * 16,
                     sp + part * 16, 16);
        }
      }
    }
    cp_async_commit();
  };

  // lane addresses of ldmatrix: K (bf16) matrices rows 0-7 d lo, rows 0-7
  // d hi, rows 8-15 d lo, rows 8-15 d hi of a k-step; K (int8) rows 0-7,
  // rows 8-15 (16 d each); V (bf16, .trans) rows 0-7 and 8-15 of n-tile
  // 2p, then of 2p + 1
  const int m = lane >> 3;
  const uint32_t k_off = kQuant ? (lane & 15) * pitch
                                : ((m >> 1) * 8 + (lane & 7)) * pitch + (m & 1) * 16;
  const uint32_t v_off = ((m & 1) * 8 + (lane & 7)) * pitch + (m >> 1) * 16;

  float mu = kNegInf, z = 0.f;                // this lane's head; z: its positions only
  float acc[kND][2];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  for (int j = 0; j < n_steps; ++j) {
    __syncwarp();                    // all lanes are done with the stage refilled next
    fetch(j + kStages - 1);
    cp_async_wait<kStages - 1>();    // this lane's copies of step j have landed
    __syncwarp();                    // ... and every lane's

    const uint32_t kst = ring_s + (j % kStages) * sbytes;
    const unsigned char* stage = ring + (j % kStages) * sbytes;
    const int t0 = (tile0 + j) * kTile + warp * kRows;

    // S = Q K^T: n-tile 0 the step's rows 0-7, n-tile 1 rows 8-15
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      if (ks < nks) {
        uint32_t b00, b01, b10, b11;
        if (kQuant) {
          uint32_t w0, w1;
          ldsm_x2(kst + k_off + ks * 16, w0, w1);
          w0 ^= 0x80808080u;
          w1 ^= 0x80808080u;
          b00 = codes_bf16(w0, 0, 1);
          b01 = codes_bf16(w0, 2, 3);
          b10 = codes_bf16(w1, 0, 1);
          b11 = codes_bf16(w1, 2, 3);
        } else {
          ldsm_x4(kst + k_off + ks * 32, b00, b01, b10, b11);
        }
        mma(s[0][0], s[0][1], qa[ks][0], qa[ks][1], b00, b01);
        mma(s[1][0], s[1][1], qa[ks][0], qa[ks][1], b10, b11);
      }
    }

    // this lane's scores: rows 2c, 2c+1 (n-tile 0) and 2c+8, 2c+9 (n-tile 1)
    const int s0 = kQuant && !scales_async ? slot(t0) : 0;   // scales read in place
    const ST* sst = reinterpret_cast<const ST*>(stage + 2 * kv_bytes);
    bool ok[2][2];
    float x[2][2], vsc[2][2];
    float mt = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nt * 8 + 2 * c + e;
        ok[nt][e] = t0 + r >= lo && t0 + r < len;
        float val = __fmul_rn(s[nt][e], scale_log2);
        vsc[nt][e] = 1.f;
        if (kQuant) {
          val = __fmul_rn(val, to_f32(scales_async ? sst[r] : ksb[wrap(s0 + r)]));
          vsc[nt][e] = to_f32(scales_async ? sst[kRows + r] : vsb[wrap(s0 + r)]);
        }
        x[nt][e] = ok[nt][e] ? val : kNegInf;
        mt = fmaxf(mt, x[nt][e]);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(mu, mt);
    const float alpha = ex2(mu - m_new);
    float p[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[nt][e] = ok[nt][e] ? ex2(x[nt][e] - m_new) : 0.f;
    z = __fmaf_rn(alpha, z, __fadd_rn(__fadd_rn(p[0][0], p[0][1]), __fadd_rn(p[1][0], p[1][1])));
    mu = m_new;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      acc[n][0] = __fmul_rn(acc[n][0], alpha);
      acc[n][1] = __fmul_rn(acc[n][1], alpha);
    }
    // P (the v scale folded in) as A fragments, in a high and a low bf16 part
    uint32_t ph[2], pl[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float w0 = kQuant ? __fmul_rn(p[nt][0], ok[nt][0] ? vsc[nt][0] : 0.f) : p[nt][0];
      const float w1 = kQuant ? __fmul_rn(p[nt][1], ok[nt][1] ? vsc[nt][1] : 0.f) : p[nt][1];
      ph[nt] = pack_bf16(w0, w1);
      const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&ph[nt]);
      pl[nt] = pack_bf16(__fsub_rn(w0, __low2float(hb)), __fsub_rn(w1, __high2float(hb)));
    }

    // Y += P V, 16 d (two n-tiles) at a time
#pragma unroll
    for (int np = 0; np < kND / 2; ++np) {
      if (np < nks) {
        uint32_t b00, b01, b10, b11;
        if (kQuant) {
          // rows 2c, 2c+1, 2c+8, 2c+9, d 16 np + 2 gq and + 1: n-tile 2 np
          // + e, column n holds d 16 np + 2 n + e
          const unsigned char* vrow = stage + kv_bytes + 16 * np + 2 * gq;
          const uint32_t w0 = *reinterpret_cast<const uint16_t*>(vrow + (2 * c) * pitch);
          const uint32_t w1 = *reinterpret_cast<const uint16_t*>(vrow + (2 * c + 1) * pitch);
          const uint32_t w2 = *reinterpret_cast<const uint16_t*>(vrow + (2 * c + 8) * pitch);
          const uint32_t w3 = *reinterpret_cast<const uint16_t*>(vrow + (2 * c + 9) * pitch);
          const uint32_t lo_rows = (w0 | (w1 << 16)) ^ 0x80808080u;
          const uint32_t hi_rows = (w2 | (w3 << 16)) ^ 0x80808080u;
          b00 = codes_bf16(lo_rows, 0, 2);
          b01 = codes_bf16(hi_rows, 0, 2);
          b10 = codes_bf16(lo_rows, 1, 3);
          b11 = codes_bf16(hi_rows, 1, 3);
        } else {
          ldsm_x4_trans(kst + kv_bytes + v_off + np * 32, b00, b01, b10, b11);
        }
        mma(acc[2 * np][0], acc[2 * np][1], ph[0], ph[1], b00, b01);
        mma(acc[2 * np + 1][0], acc[2 * np + 1][1], ph[0], ph[1], b10, b11);
        mma(acc[2 * np][0], acc[2 * np][1], pl[0], pl[1], b00, b01);
        mma(acc[2 * np + 1][0], acc[2 * np + 1][1], pl[0], pl[1], b10, b11);
      }
    }
  }
  cp_async_wait<0>();                // only empty groups remain; drain before reuse

  // the quad's Z (each lane summed its own positions), in a fixed order
  z = __fadd_rn(z, __shfl_xor_sync(0xffffffffu, z, 1));
  z = __fadd_rn(z, __shfl_xor_sync(0xffffffffu, z, 2));

  // then the warps, through shared memory, in warp order
  __syncthreads();                   // every warp is done with its ring
  float* sy = reinterpret_cast<float*>(smem);          // [kWarps][G][D]
  float* smu = sy + kWarps * G * D;                    // [kWarps][G]
  float* sz = smu + kWarps * G;                        // [kWarps][G]
  float* cy = sz + kWarps * G;                         // [G][D]: this CTA's state
  float* cmz = cy + G * D;                             // [G][2]
  if (gq < G) {
    float* row = sy + (warp * G + gq) * D;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      if (n < 2 * nks) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // C column 2c + i of n-tile n: the d it holds
          const int d = kQuant ? 16 * (n >> 1) + 2 * (2 * c + i) + (n & 1) : 8 * n + 2 * c + i;
          row[d] = acc[n][i];
        }
      }
    }
    if (c == 0) {
      smu[warp * G + gq] = mu;
      sz[warp * G + gq] = z;
    }
  }
  __syncthreads();
  __nv_bfloat16* ob = out + static_cast<size_t>(bh) * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    float mm = smu[g], zz = sz[g], yy = sy[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(mm, zz, yy, smu[w * G + g], sz[w * G + g], sy[w * G * D + e]);
    if (n_split == 1) {
      // the one deferred division; Z == 0 (no valid position) gives an exact 0
      ob[e] = __float2bfloat16(zz > 0.f ? yy / zz : 0.f);
    } else {
      cy[e] = yy;
      if (e - g * D == 0) {
        cmz[2 * g] = mm;
        cmz[2 * g + 1] = zz;
      }
    }
  }
  if (n_split > 1) {
    // the cluster's CTAs are the splits in order (rank == blockIdx.y):
    // rank 0 folds their states from distributed shared memory
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                  // every split's state is in its shared memory
    if (split == 0) {
      for (int e = tid; e < G * D; e += kThreads) {
        const int g = e / D;
        float mm = cmz[2 * g], zz = cmz[2 * g + 1], yy = cy[e];
        for (int r = 1; r < n_split; ++r) {
          const float* ry = cluster.map_shared_rank(cy, r);
          const float* rmz = cluster.map_shared_rank(cmz, r);
          merge(mm, zz, yy, rmz[2 * g], rmz[2 * g + 1], ry[e]);
        }
        ob[e] = __float2bfloat16(zz > 0.f ? yy / zz : 0.f);
      }
    }
    cluster.sync();                  // rank 0 is done reading the others' shared memory
  }
}

// the dynamic shared memory of a launch at (G, D)
template <typename KT, typename ST>
size_t smem_bytes(int G, int D) {
  const size_t ring = ring_bytes<KT, ST>(D);
  const size_t mrg = merge_bytes(G, D);
  return ring > mrg ? ring : mrg;
}

// lets the instance take `smem` bytes of dynamic shared memory, with the
// carveout at its largest; raises the instance's limit, never lowers it
template <typename KT, typename ST, int kD>
cudaError_t allow_smem(size_t smem) {
  static size_t smem_allowed = 0;    // per instance
  if (smem <= smem_allowed) return cudaSuccess;
  auto kernel = swiftkv_mma_kernel<KT, ST, kD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) smem_allowed = smem;
  return err;
}

// what the card holds of the instance at (G, D), as launch() launches it:
// out[0] its CTAs per SM, out[n] for n = 1..kMaxSplit the clusters of n
// CTAs that can be resident at once (ops.py's split policy reads both)
template <typename KT, typename ST, int kD>
int occupancy(int G, int D, int* out) {
  auto kernel = swiftkv_mma_kernel<KT, ST, kD>;
  const size_t smem = smem_bytes<KT, ST>(G, D);
  cudaError_t err = allow_smem<KT, ST, kD>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads, smem);
  for (int n = 1; n <= kMaxSplit && err == cudaSuccess; ++n) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, n);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = n;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&out[n], kernel, &cfg);
  }
  return static_cast<int>(err);
}

template <typename KT, typename ST, int kD>
int launch(const void* q, const void* k, const void* v, const void* lengths, const void* entries,
           const void* k_scale, const void* v_scale, void* out, int B, int S, int Hkv, int G,
           int D, int window, int is_ring, float scale, int n_split, cudaStream_t stream) {
  auto kernel = swiftkv_mma_kernel<KT, ST, kD>;
  const size_t smem = smem_bytes<KT, ST>(G, D);
  const cudaError_t set = allow_smem<KT, ST, kD>(smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int copy16 = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int scales_async = S % 16 == 0 && reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(v_scale) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(entries), static_cast<const ST*>(k_scale),
      static_cast<const ST*>(v_scale), static_cast<__nv_bfloat16*>(out), S, Hkv, G, D, window,
      is_ring, scale * kLog2E, n_split, copy16, scales_async);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// the fragments' compile-time bound on D: 32, 64, 80 (h2o-danube-1.8b),
// 128 or 256
template <typename KT, typename ST>
int launch_d(const void* q, const void* k, const void* v, const void* lengths,
             const void* entries, const void* ks, const void* vs, void* out, int B, int S,
             int Hkv, int G, int D, int window, int is_ring, float scale, int n_split,
             cudaStream_t st) {
  if (D <= 32)
    return launch<KT, ST, 32>(q, k, v, lengths, entries, ks, vs, out, B, S, Hkv, G, D, window,
                              is_ring, scale, n_split, st);
  if (D <= 64)
    return launch<KT, ST, 64>(q, k, v, lengths, entries, ks, vs, out, B, S, Hkv, G, D, window,
                              is_ring, scale, n_split, st);
  if (D <= 80)
    return launch<KT, ST, 80>(q, k, v, lengths, entries, ks, vs, out, B, S, Hkv, G, D, window,
                              is_ring, scale, n_split, st);
  if (D <= 128)
    return launch<KT, ST, 128>(q, k, v, lengths, entries, ks, vs, out, B, S, Hkv, G, D, window,
                               is_ring, scale, n_split, st);
  return launch<KT, ST, kMaxD>(q, k, v, lengths, entries, ks, vs, out, B, S, Hkv, G, D, window,
                               is_ring, scale, n_split, st);
}

template <typename KT, typename ST>
int occupancy_d(int G, int D, int* out) {
  if (D <= 32) return occupancy<KT, ST, 32>(G, D, out);
  if (D <= 64) return occupancy<KT, ST, 64>(G, D, out);
  if (D <= 80) return occupancy<KT, ST, 80>(G, D, out);
  if (D <= 128) return occupancy<KT, ST, 128>(G, D, out);
  return occupancy<KT, ST, kMaxD>(G, D, out);
}

}  // namespace

// q, out: [B, Hkv, G, D] bf16, 8-byte aligned; k, v: [B, S, Hkv, D]
// (kv_dtype: 1 bf16, 16-byte aligned, or 2 int8, 8-byte aligned); lengths:
// [B] int32; entries: [B] int32 or null: with entries, k, v are a pool
// [E, S, Hkv, D] (scales [E, Hkv, S]) and row b reads entry entries[b] (in
// [0, E)); k_scale, v_scale: [B, Hkv, S] (scale_dtype 0 f32, 1 bf16) for
// an int8 cache, else null. G 1..8, D a multiple of 16 up to 256. window
// <= 0 means none. is_ring != 0: the caches are rings of S slots (needs a
// window). n_split (1..8): CTAs, one cluster, per (row, KV head).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int swiftkv_decode_mma_launch(const void* q, const void* k, const void* v,
                                         const void* lengths, const void* entries,
                                         const void* k_scale, const void* v_scale, void* out,
                                         int B, int S, int Hkv, int G, int D, int window,
                                         int is_ring, float scale, int n_split, int kv_dtype,
                                         int scale_dtype, void* stream) {
  if (G < 1 || G > kMaxG || D < 16 || D > kMaxD || D % 16 != 0 || B < 1 || Hkv < 1 || S < 1 ||
      n_split < 1 || n_split > kMaxSplit || (is_ring && window <= 0) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kBF16)
    return launch_d<__nv_bfloat16, float>(q, k, v, lengths, entries, nullptr, nullptr, out, B,
                                          S, Hkv, G, D, window, is_ring, scale, n_split, st);
  if (kv_dtype == kI8 && scale_dtype == kBF16)
    return launch_d<int8_t, __nv_bfloat16>(q, k, v, lengths, entries, k_scale, v_scale, out,
                                           B, S, Hkv, G, D, window, is_ring, scale, n_split,
                                           st);
  if (kv_dtype == kI8 && scale_dtype == kF32)
    return launch_d<int8_t, float>(q, k, v, lengths, entries, k_scale, v_scale, out, B, S, Hkv,
                                   G, D, window, is_ring, scale, n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The occupancy of the instance that swiftkv_decode_mma_launch takes at (G,
// D, kv_dtype, scale_dtype), its shared memory set as a launch sets it:
// out[0] = cudaOccupancyMaxActiveBlocksPerMultiprocessor, out[n] for n =
// 1..8 = cudaOccupancyMaxActiveClusters with clusters of (1, n, 1) CTAs
// (out: 9 ints). Returns the cudaError_t of the queries (0 on success).
extern "C" int swiftkv_decode_mma_occupancy(int G, int D, int kv_dtype, int scale_dtype,
                                            int* out) {
  if (G < 1 || G > kMaxG || D < 16 || D > kMaxD || D % 16 != 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == kBF16) return occupancy_d<__nv_bfloat16, float>(G, D, out);
  if (kv_dtype == kI8 && scale_dtype == kBF16)
    return occupancy_d<int8_t, __nv_bfloat16>(G, D, out);
  if (kv_dtype == kI8 && scale_dtype == kF32) return occupancy_d<int8_t, float>(G, D, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
