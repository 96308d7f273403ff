// SwiftKV single-pass decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swiftkv_decode/kernel.py:
// swiftkv_decode_pallas (body _kernel). Same function: one query token per
// (row, query head) against a KV cache in its native [B, S, Hkv, D] layout,
// folded in ONE pass with the running triple (mu, Z, Y):
//     mu' = max(mu, s_t)
//     Z, Y <- e^(mu - mu') (Z, Y) + e^(s_t - mu') (1, v_t)
// and one deferred division at the end; a row with Z == 0 (no valid
// position) writes an exact 0. The G = Hq / Hkv query heads of a KV head
// share every K/V read. Positions outside [lo, len) are never loaded, with
// len = min(lengths[b], S) and lo = max(0, len - window) when a window is
// given. int8 caches carry per-position scales [B, Hkv, S] (f32 or bf16),
// folded into the score (s_t = k_scale[t] q.k_t) and into the weight of
// v_t (p_t v_scale[t]) rather than into every element.
//
// The ring form (the TPU kernel's ring=True) reads a ring of R = S slots
// in place: lengths[b] counts the tokens seen and may exceed S, and slot s
// holds position p - ((p - s) mod S), p = lengths[b] - 1. The TPU kernel
// streams every slot and masks by that position; here the kernel works in
// position space instead: the valid positions are the one run [lo, len)
// with len = lengths[b] (unclamped) and lo = max(0, len - min(window, S)),
// and position t lives in slot t mod S. So the ring form is the windowed
// linear form with each row's copy address, and its scale index, taken at
// t mod S: it reads the window and nothing else of the ring, and it folds
// the same tiles in the same order as the linear form on a cache holding
// the same positions, so the two agree bit for bit. A tile may straddle
// the wrap; its rows are addressed one by one, so that costs nothing.
//
// The pooled form (entries != null; cross attention over a shared
// source-KV pool, the reference's core/swiftkv.py swiftkv_decode_pooled)
// reads k, v as a pool [E, S, Hkv, D] and row b's entry e = entries[b]:
// the row's cache base and scale planes are taken at e in place of b,
// and nothing else changes (q and out stay row b's), so it is bit for bit
// the read of the gathered copy k[entries]. entries[b] is loaded beside
// lengths[b], both before the first copy. Rows that share an entry read
// the same bytes.
//
// Bound on an H100: bytes. Each (row, KV head) reads (len - lo) x D
// elements of K and of V once; the arithmetic is ~4 G D flops per
// position, far below the ~295 flops per byte at which the tensor cores
// would become the limit. At llama2-7b decode (B = 8, Hkv = 32, D = 128,
// len 576, bf16) that is 75 MB per layer, 22.6 us at 3.35 TB/s; an int8
// cache halves it. So the design is about memory-level parallelism:
//
// 1. Split S across CTAs. The grid is (B * Hkv, n_split); each CTA folds
//    one contiguous run of 32-position tiles (tile-aligned in absolute
//    positions) of [lo, len) into a partial (mu, Z, Y). The host picks
//    n_split from shapes, dtypes and what the card holds of the instance
//    (swiftkv_decode_occupancy below, asked once per instance), never from
//    lengths, so a launch reads no device value and can be captured in a
//    CUDA graph; each CTA derives its chunk from its row's len. The n_split CTAs of a
//    (row, head) form one thread-block cluster: after a cluster barrier,
//    the CTA of rank 0 reads the others' partial states from their shared
//    memory (distributed shared memory), folds them in split order with
//    state_merge and divides once. No second launch, no partial buffer in
//    device memory, no float atomics: a run repeats itself bit for bit.
//    A chunk wholly outside [lo, len) holds the empty state (-1e30, 0, 0),
//    and all-empty partials finalize to an exact 0.
//    The policy (ops.py::split_count) models the launch's waves of
//    clusters and the tile bytes its resident CTAs keep in flight: n_split
//    stays 1 where B x Hkv already keeps the memory busy (llama2-7b decode
//    at batch 8), where more splits only add per-CTA start-up and the
//    merge, and grows where few pairs read long rows (whisper-small's cross
//    read: 96 pairs of 1500 positions, n_split 3).
// 2. Overlap loads with math. Each warp owns a ring of 3 stages of
//    kWarpRows cache rows of K and V in shared memory, filled with 16-byte
//    cp.async (8-byte where a row is not a multiple of 16 bytes: an int8
//    cache with D % 16 == 8). An int8 cache's per-position scales ride the
//    same stages (read in place instead where S % 8 != 0). Stages j+1 and
//    j+2 are in flight while stage j is folded. A warp reads only the rows
//    it copied itself, so the loop has no __syncthreads at all, only
//    __syncwarp; the CTA meets once, at the end, to merge its four warps'
//    states.
// 3. Keep tiles in their storage type. Rows land in shared memory as
//    f32, bf16 or int8 bytes and are widened to f32 in registers as they
//    are read: at D = 128 bf16 a CTA holds 48 KB (int8: 24 KB) for three
//    stages, against 66 KB for one f32 tile in the first version.
//
// Inside a warp, a group of L = pow2ceil(D / 8) lanes owns one position at
// a time; each lane holds 8 elements of q (every query head), of the row
// and of Y. A lane group folds its rows of a stage in batches of 4 (2 at
// G > 4): the batch's dot products reduce across the group by shuffles,
// interleaved, then one max, one rescale of (Z, Y) and one exp per row,
// as state_update_block does for a block. Lane groups merge by shuffles,
// warps through shared memory, all in a fixed order. Every rounding of the
// fold and the merges is written out (__fmul_rn, __fadd_rn, __fmaf_rn), so
// the two exponentials below share one arithmetic that the compiler cannot
// contract differently: (Z, Y) <- fma(alpha, (Z, Y), first row's term),
// then one fma per further row; a merge is fma(e_a, a, e_b * b).
//
// The LUT form (the TPU kernel's exp_mode="lut", its _exp_lut): every
// exponential of the fold and of the merges is the paper's Eq. 9-10
// exponential, exp_lut() below, instead of __expf / expf. The launcher
// takes it when given the table (a non-null lut pointer: the 32 values,
// then the 32 slopes, float32 as the reference casts make_lut's float64
// table) and launches the kernel's kLut = true instance. A template flag,
// not a runtime one: measured on an H100, a runtime flag in one kernel
// (nvcc then unswitches the loop into both forms anyway, ~47 s of build
// against ~69 s for the two instances) slowed the native form by 3-9% at
// D = 80 and at G = 4, where the two instances match the native kernel
// alone. Each CTA copies the table into shared memory once; 32 entries of
// 4 bytes lie in 32 distinct banks, so lanes that index it divergently
// never conflict. The
// arithmetic is written out so that nvcc cannot contract or flush it
// differently from the reference (XLA compiles it with one fused
// multiply-add for the interpolation and flushes subnormals): products
// and differences by __fmul_rn / __fsub_rn, the interpolation by
// __fmaf_rn, and a result below 2^-126 set to 0 by hand (the build has no
// -ftz). With n clamped to -126, exp_lut(-1e30) is 2^-126, not 0: masked
// rows keep their select to 0, and an empty state's (mu = -1e30, Z = 0,
// Y = 0) weight multiplies zeros. swiftkv_exp_lut_launch applies the same
// function elementwise, so a test can hold it bit for bit to its plain
// version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 8;                  // cache rows per warp per stage
constexpr int kTile = kWarps * kWarpRows;     // 32: positions per CTA step
constexpr int kStages = 3;                    // ring depth per warp
constexpr int kMaxSplit = 8;                  // CTAs per cluster (portable limit)
constexpr int kMaxG = 8;                      // query heads per KV head
constexpr int kMaxD = 256;                    // head dim
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF
constexpr int kLutSize = 32;                  // Eq. 10's table
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kFltMin = 1.17549435e-38f;    // 2^-126

// the LUT form's table in shared memory: values [0, 32), slopes [32, 64)
__shared__ float s_lut[2 * kLutSize];

// exp(x) for x <= 0 as the reference kernel's _exp_lut computes it: 2^n
// (n = ceil(x log2 e) clamped to [-126, 0]) from exponent bits, 2^f from
// the table by linear interpolation, a subnormal result flushed to 0.
__device__ __forceinline__ float exp_lut(float x) {
  const float y = __fmul_rn(x, kLog2E);
  const float n = ceilf(y);
  const float u = __fmul_rn(-__fsub_rn(y, n), static_cast<float>(kLutSize));   // [0, 32)
  const int idx = min(max(static_cast<int>(u), 0), kLutSize - 1);
  const float f2 = __fsub_rn(u, static_cast<float>(idx));
  const float frac = __fmaf_rn(s_lut[kLutSize + idx], f2, s_lut[idx]);
  const int e = static_cast<int>(fminf(fmaxf(n, -126.f), 0.f));
  const float pow2n = __int_as_float((e + 127) << 23);
  const float out = __fmul_rn(frac, pow2n);
  return out < kFltMin ? 0.f : out;
}

// copy the table into shared memory (every thread calls; blockDim >= 64)
__device__ __forceinline__ void load_lut(const float* lut) {
  if (threadIdx.x < 2 * kLutSize) s_lut[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
}

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight consecutive elements of a shared-memory row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float out[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// state_merge of (mu, z, y[n]) with (mu_b, z_b, y_b[n]), in place; lut:
// the LUT form's exponential.
template <int N>
__device__ __forceinline__ void merge(float& mu, float& z, float* y, float mu_b, float z_b,
                                      const float* y_b, bool lut) {
  const float m = fmaxf(mu, mu_b);
  const float ea = lut ? exp_lut(mu - m) : expf(mu - m);
  const float eb = lut ? exp_lut(mu_b - m) : expf(mu_b - m);
  z = __fmaf_rn(ea, z, __fmul_rn(eb, z_b));
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = __fmaf_rn(ea, y[i], __fmul_rn(eb, y_b[i]));
  mu = m;
}

// Shared memory (dynamic): during the loop, warp w's ring of kStages
// stages, each K rows [kWarpRows][D] and V rows [kWarpRows][D] in the
// cache's type and, for int8, the rows' k and v scales [kWarpRows] in
// theirs; after it, the same bytes hold the warps' states for the CTA
// merge, y [kWarps][G][D], mu [kWarps][G], z [kWarps][G], then the CTA's
// state for the cluster merge, y [G][D], (mu, z) [G][2] (all f32).
template <typename KT, typename ST>
__host__ __device__ constexpr int stage_bytes(int D) {
  return 2 * kWarpRows * D * static_cast<int>(sizeof(KT)) +
         (std::is_same<KT, int8_t>::value ? 2 * kWarpRows * static_cast<int>(sizeof(ST)) : 0);
}
template <typename KT, typename ST>
__host__ __device__ constexpr size_t ring_bytes(int D) {
  return static_cast<size_t>(kWarps) * kStages * stage_bytes<KT, ST>(D);
}
__host__ __device__ constexpr size_t merge_bytes(int G, int D) {
  return static_cast<size_t>(kWarps + 1) * G * (D + 2) * sizeof(float);
}

// q, out: [B, Hkv, G, D]; k, v: [B, S, Hkv, D]; lengths: [B]; entries:
// [B] or null (then k, v: [E, S, Hkv, D], scales [E, Hkv, S]);
// k_scale, v_scale: [B, Hkv, S] for an int8 cache, else null. Launched with
// clusters of (1, n_split, 1) CTAs when n_split > 1. kG >= G is the
// compile-time bound on G. is_ring: the caches are rings of S slots (above).
// copy16: rows are copied 16 bytes at a time (else 8). scales_async: the
// int8 scales ride the ring by cp.async (S % 8 == 0, 16-byte aligned
// planes), else they are read from global memory as they are used. lut:
// the LUT form's table [64] (values, slopes), or null for the native exp.
template <typename QT, typename KT, typename ST, int kG, bool kLut>
__global__ void __launch_bounds__(kThreads)
swiftkv_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, const int* __restrict__ lengths,
                     const int* __restrict__ entries,
                     const ST* __restrict__ k_scale, const ST* __restrict__ v_scale,
                     const float* __restrict__ lut, QT* __restrict__ out, int S, int Hkv,
                     int G, int D, int window, int is_ring, float scale, int n_split,
                     int copy16, int scales_async) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int kBatch = kG >= 8 ? 2 : 4;     // rows a lane group folds together
  extern __shared__ __align__(16) unsigned char smem[];

  const int bh = blockIdx.x;                  // b * Hkv + h
  const int split = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (kLut) load_lut(lut);

  // lane groups: L lanes per position, 8 elements per lane
  const int n_chunks = D / 8;
  int lpp = 1;
  while (lpp < n_chunks) lpp <<= 1;
  const int n_groups = 32 / lpp;
  const int grp = lane / lpp;
  const int c = lane - grp * lpp;
  const bool c_ok = c < n_chunks;
  const int cc = c_ok ? c : 0;                // lanes past D read chunk 0 with q = 0
  const int rows_per_group = max(1, kWarpRows / n_groups);

  // q first: it does not depend on len
  float qr[kG][8];
  const QT* qb = q + static_cast<size_t>(bh) * G * D + cc * 8;
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      qr[g][i] = (g < G && c_ok) ? __fmul_rn(to_f32(qb[g * D + i]), scale) : 0.f;

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
  const int kv_bytes = kWarpRows * row_bytes;         // the K (or V) rows of a stage
  const int sbytes = stage_bytes<KT, ST>(D);
  unsigned char* ring = smem + static_cast<size_t>(warp) * kStages * sbytes;
  const size_t pos_stride = static_cast<size_t>(Hkv) * row_bytes;   // bytes
  const size_t head_off = static_cast<size_t>(e) * S * pos_stride +
                          static_cast<size_t>(h) * row_bytes;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) + head_off;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + head_off;
  const size_t plane = (static_cast<size_t>(e) * Hkv + h) * S;   // scale plane
  const ST* ksb = kQuant ? k_scale + plane : nullptr;
  const ST* vsb = kQuant ? v_scale + plane : nullptr;

  // copy addressing: where the copies of a row divide the warp evenly, a
  // lane copies column lcol of rows lrow, lrow + rstep, ...
  const int width = copy16 ? 16 : 8;
  const int per_row = row_bytes / width;
  const bool even = per_row <= 32 && 32 % per_row == 0;
  const int rstep = even ? 32 / per_row : 1;
  const int lrow = even ? lane / per_row : 0;
  const int lcol = even ? (lane % per_row) * width : 0;
  // the slot of a warp's first row t0 of a step (t0 >= 0; below S in the
  // linear form): one division per step; row r of the step lies in slot
  // wrap(slot(t0) + r), which divides again only past the wrap
  auto slot = [&](int t0) { return is_ring ? t0 % S : t0; };
  auto wrap = [&](int sl) { return sl >= S ? sl % S : sl; };

  // copy this warp's rows of step j (positions in [lo, len) only) into
  // stage j % kStages; always commit, so group j is step j's copies
  auto fetch = [&](int j) {
    if (j < n_steps) {
      const int t0 = (tile0 + j) * kTile + warp * kWarpRows;
      const int r0 = max(0, lo - t0);
      const int r1 = min(kWarpRows, len - t0);
      const int s0 = slot(t0);
      unsigned char* dst = ring + (j % kStages) * sbytes;
      auto copy = [&](int r, int off) {
        const size_t src = static_cast<size_t>(wrap(s0 + r)) * pos_stride + off;
        unsigned char* d = dst + r * row_bytes + off;
        if (copy16) {
          cp_async16(d, kb + src);
          cp_async16(d + kv_bytes, vb + src);
        } else {
          cp_async8(d, kb + src);
          cp_async8(d + kv_bytes, vb + src);
        }
      };
      if (even) {
        for (int r = r0 + lrow; r < r1; r += rstep) copy(r, lcol);
      } else {
        for (int e = lane; e < (r1 - r0) * per_row; e += 32)
          copy(r0 + e / per_row, (e % per_row) * width);
      }
      if (kQuant && scales_async && r1 > r0) {
        // all 8 rows' scales: t0 % 8 == 0 and S % 8 == 0 keep them inside
        // this (row, head)'s plane, and in one run of slots on a ring
        constexpr int n16 = kWarpRows * static_cast<int>(sizeof(ST)) / 16;
        if (lane < 2 * n16) {
          const int which = lane / n16;
          const int part = lane - which * n16;
          const ST* sp = (which ? vsb : ksb) + s0;
          cp_async16(dst + 2 * kv_bytes + which * kWarpRows * sizeof(ST) + part * 16,
                     reinterpret_cast<const unsigned char*>(sp) + part * 16);
        }
      }
    }
    cp_async_commit();
  };

  float mu[kG], z[kG], y[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    mu[g] = kNegInf;
    z[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) y[g][i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  for (int j = 0; j < n_steps; ++j) {
    __syncwarp();                    // all lanes are done with the stage refilled next
    fetch(j + kStages - 1);
    cp_async_wait<kStages - 1>();    // this lane's copies of step j have landed
    __syncwarp();                    // ... and every lane's

    const unsigned char* kst = ring + (j % kStages) * sbytes;
    const unsigned char* vst = kst + kv_bytes;
    const ST* sst = reinterpret_cast<const ST*>(kst + 2 * kv_bytes);
    const int t0 = (tile0 + j) * kTile + warp * kWarpRows;
    const int s0 = kQuant && !scales_async ? slot(t0) : 0;  // scales read in place
    for (int i0 = 0; i0 < rows_per_group; i0 += kBatch) {   // uniform across the warp
      // scores of the batch's rows; invalid rows read a valid address and
      // are masked out below
      bool valid[kBatch];
      int rr[kBatch];
      float s[kBatch][kG];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int r = grp + (i0 + i) * n_groups;
        valid[i] = i0 + i < rows_per_group && r < kWarpRows && t0 + r >= lo && t0 + r < len;
        rr[i] = valid[i] ? r : 0;
        float kf[8];
        load8(reinterpret_cast<const KT*>(kst + rr[i] * row_bytes) + cc * 8, kf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = __fmaf_rn(qr[g][e], kf[e], acc);
          s[i][g] = acc;
        }
      }
      for (int o = 1; o < lpp; o <<= 1) {   // sum over the lane group, rows interleaved
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            s[i][g] = __fadd_rn(s[i][g], __shfl_xor_sync(0xffffffffu, s[i][g], o));
      }
      float vsc[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        float ksc = 1.f;
        vsc[i] = 1.f;
        if (kQuant && valid[i]) {
          ksc = to_f32(scales_async ? sst[rr[i]] : ksb[wrap(s0 + rr[i])]);
          vsc[i] = to_f32(scales_async ? sst[kWarpRows + rr[i]] : vsb[wrap(s0 + rr[i])]);
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (kQuant) s[i][g] = __fmul_rn(s[i][g], ksc);
      }
      float vf[kBatch][8];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (valid[i]) {
          load8(reinterpret_cast<const KT*>(vst + rr[i] * row_bytes) + cc * 8, vf[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) vf[i][e] = 0.f;
        }
      }
      // fold the batch: one max, one rescale of (Z, Y)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float m = mu[g];
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (valid[i]) m = fmaxf(m, s[i][g]);
        const float alpha = kLut ? exp_lut(mu[g] - m) : __expf(mu[g] - m);
        float psum = 0.f, pv[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const float p =
              valid[i] ? (kLut ? exp_lut(s[i][g] - m) : __expf(s[i][g] - m)) : 0.f;
          psum = __fadd_rn(psum, p);
          pv[i] = kQuant ? __fmul_rn(p, vsc[i]) : p;
        }
        z[g] = __fmaf_rn(alpha, z[g], psum);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float acc = __fmaf_rn(alpha, y[g][e], __fmul_rn(pv[0], vf[0][e]));
#pragma unroll
          for (int i = 1; i < kBatch; ++i) acc = __fmaf_rn(pv[i], vf[i][e], acc);
          y[g][e] = acc;
        }
        mu[g] = m;
      }
    }
  }
  cp_async_wait<0>();                // only empty groups remain; drain before reuse

  // merge the lane groups of this warp (same chunk, other positions)
  for (int o = lpp; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float yb[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) yb[e] = __shfl_xor_sync(0xffffffffu, y[g][e], o);
      const float mu_b = __shfl_xor_sync(0xffffffffu, mu[g], o);
      const float z_b = __shfl_xor_sync(0xffffffffu, z[g], o);
      merge<8>(mu[g], z[g], y[g], mu_b, z_b, yb, kLut);
    }
  }

  // then the warps, through shared memory, in warp order
  __syncthreads();                   // every warp is done with its ring
  float* sy = reinterpret_cast<float*>(smem);          // [kWarps][G][D]
  float* smu = sy + kWarps * G * D;                    // [kWarps][G]
  float* sz = smu + kWarps * G;                        // [kWarps][G]
  float* cy = sz + kWarps * G;                         // [G][D]: this CTA's state
  float* cmz = cy + G * D;                             // [G][2]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
        if (c_ok) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sy[(warp * G + g) * D + c * 8 + e] = y[g][e];
        }
        if (c == 0) {
          smu[warp * G + g] = mu[g];
          sz[warp * G + g] = z[g];
        }
      }
    }
  }
  __syncthreads();
  QT* ob = out + static_cast<size_t>(bh) * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    float m = smu[g], zz = sz[g], yy = sy[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      merge<1>(m, zz, &yy, smu[w * G + g], sz[w * G + g], &sy[w * G * D + e], kLut);
    if (n_split == 1) {
      // the one deferred division; Z == 0 (no valid position) gives an exact 0
      store(ob + e, zz > 0.f ? yy / zz : 0.f);
    } else {
      cy[e] = yy;
      if (e - g * D == 0) {
        cmz[2 * g] = m;
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
        float m = cmz[2 * g], zz = cmz[2 * g + 1], yy = cy[e];
        for (int r = 1; r < n_split; ++r) {
          const float* ry = cluster.map_shared_rank(cy, r);
          const float* rmz = cluster.map_shared_rank(cmz, r);
          merge<1>(m, zz, &yy, rmz[2 * g], rmz[2 * g + 1], &ry[e], kLut);
        }
        store(ob + e, zz > 0.f ? yy / zz : 0.f);
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
template <typename QT, typename KT, typename ST, int kG, bool kLut>
cudaError_t allow_smem(size_t smem) {
  static size_t smem_allowed = 0;    // per kernel
  if (smem <= smem_allowed) return cudaSuccess;
  auto kernel = swiftkv_split_kernel<QT, KT, ST, kG, kLut>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) smem_allowed = smem;
  return err;
}

// what the card holds of the kernel at (G, D), as launch() launches it:
// out[0] its CTAs per SM, out[n] for n = 1..kMaxSplit the clusters of n
// CTAs that can be resident at once (ops.py's split policy reads both)
template <typename QT, typename KT, typename ST, int kG, bool kLut>
int occupancy(int G, int D, int* out) {
  auto kernel = swiftkv_split_kernel<QT, KT, ST, kG, kLut>;
  const size_t smem = smem_bytes<KT, ST>(G, D);
  cudaError_t err = allow_smem<QT, KT, ST, kG, kLut>(smem);
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

template <typename QT, typename KT, typename ST, int kG>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* entries, const void* k_scale, const void* v_scale, const float* lut,
           void* out, int B, int S, int Hkv, int G, int D, int window, int is_ring,
           float scale, int n_split, cudaStream_t stream) {
  auto kernel = lut ? swiftkv_split_kernel<QT, KT, ST, kG, true>
                    : swiftkv_split_kernel<QT, KT, ST, kG, false>;
  const size_t smem = smem_bytes<KT, ST>(G, D);
  const cudaError_t set = lut ? allow_smem<QT, KT, ST, kG, true>(smem)
                              : allow_smem<QT, KT, ST, kG, false>(smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int row_bytes = D * static_cast<int>(sizeof(KT));
  const int copy16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int scales_async = S % 8 == 0 && reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
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
      &cfg, kernel, static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(entries), static_cast<const ST*>(k_scale),
      static_cast<const ST*>(v_scale), lut, static_cast<QT*>(out), S, Hkv, G, D, window,
      is_ring, scale, n_split, copy16, scales_async);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename QT, typename KT, typename ST>
int launch_g(const void* q, const void* k, const void* v, const void* lengths,
             const void* entries, const void* ks, const void* vs, const float* lut,
             void* out, int B, int S, int Hkv, int G, int D, int window, int is_ring,
             float scale, int n_split, cudaStream_t st) {
  if (G <= 1)
    return launch<QT, KT, ST, 1>(q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv, G,
                                 D, window, is_ring, scale, n_split, st);
  if (G <= 2)
    return launch<QT, KT, ST, 2>(q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv, G,
                                 D, window, is_ring, scale, n_split, st);
  if (G <= 4)
    return launch<QT, KT, ST, 4>(q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv, G,
                                 D, window, is_ring, scale, n_split, st);
  return launch<QT, KT, ST, kMaxG>(q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv, G,
                                   D, window, is_ring, scale, n_split, st);
}

template <typename QT, typename KT, typename ST>
int occupancy_g(int G, int D, int lut, int* out) {
  if (G <= 1)
    return lut ? occupancy<QT, KT, ST, 1, true>(G, D, out)
               : occupancy<QT, KT, ST, 1, false>(G, D, out);
  if (G <= 2)
    return lut ? occupancy<QT, KT, ST, 2, true>(G, D, out)
               : occupancy<QT, KT, ST, 2, false>(G, D, out);
  if (G <= 4)
    return lut ? occupancy<QT, KT, ST, 4, true>(G, D, out)
               : occupancy<QT, KT, ST, 4, false>(G, D, out);
  return lut ? occupancy<QT, KT, ST, kMaxG, true>(G, D, out)
             : occupancy<QT, KT, ST, kMaxG, false>(G, D, out);
}

}  // namespace

// The build compiles this file as five units at once (-DSKV_UNIT=0..4, see
// kernels/_build.py): one unit of the 64 kernel instances took nvcc ~105 s
// on the card's host, the longest step of the build. Units 0-3 each hold
// the launcher part of one (q dtype, cache family: float or int8) and so
// its 16 instances (G bucket x cache and scale dtype x native/LUT); unit 4
// holds the C entry points, which call the parts.
#ifndef SKV_UNIT
#error "compile with -DSKV_UNIT=0..4, as kernels/_build.py does"
#endif

// the launcher and the occupancy query of one (QT, cache family) part:
// kInt8 false takes f32 and bf16 caches, true int8 caches with bf16 or f32
// scales; kv_dtype is checked by the entry point
template <typename QT, bool kInt8>
int launch_part(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
                const void* lengths, const void* entries, const void* ks, const void* vs,
                const float* lut, void* out, int B, int S, int Hkv, int G, int D, int window,
                int is_ring, float scale, int n_split, cudaStream_t st);
template <typename QT, bool kInt8>
int occupancy_part(int kv_dtype, int scale_dtype, int G, int D, int lut, int* out);

#if SKV_UNIT != 4
template <typename QT, bool kInt8>
int launch_part(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
                const void* lengths, const void* entries, const void* ks, const void* vs,
                const float* lut, void* out, int B, int S, int Hkv, int G, int D, int window,
                int is_ring, float scale, int n_split, cudaStream_t st) {
  if constexpr (!kInt8) {
    if (kv_dtype == kF32)
      return launch_g<QT, float, float>(q, k, v, lengths, entries, nullptr, nullptr, lut, out,
                                        B, S, Hkv, G, D, window, is_ring, scale, n_split, st);
    return launch_g<QT, __nv_bfloat16, float>(q, k, v, lengths, entries, nullptr, nullptr,
                                              lut, out, B, S, Hkv, G, D, window, is_ring,
                                              scale, n_split, st);
  } else {
    if (scale_dtype == kBF16)
      return launch_g<QT, int8_t, __nv_bfloat16>(q, k, v, lengths, entries, ks, vs, lut, out,
                                                 B, S, Hkv, G, D, window, is_ring, scale,
                                                 n_split, st);
    return launch_g<QT, int8_t, float>(q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv,
                                       G, D, window, is_ring, scale, n_split, st);
  }
}

template <typename QT, bool kInt8>
int occupancy_part(int kv_dtype, int scale_dtype, int G, int D, int lut, int* out) {
  if constexpr (!kInt8) {
    if (kv_dtype == kF32) return occupancy_g<QT, float, float>(G, D, lut, out);
    return occupancy_g<QT, __nv_bfloat16, float>(G, D, lut, out);
  } else {
    if (scale_dtype == kBF16) return occupancy_g<QT, int8_t, __nv_bfloat16>(G, D, lut, out);
    return occupancy_g<QT, int8_t, float>(G, D, lut, out);
  }
}
#endif

#define SKV_PART(QT, INT8)                                                                   \
  template int launch_part<QT, INT8>(int, int, const void*, const void*, const void*,       \
                                     const void*, const void*, const void*, const void*,    \
                                     const float*, void*, int, int, int, int, int, int, int, \
                                     float, int, cudaStream_t);                              \
  template int occupancy_part<QT, INT8>(int, int, int, int, int, int*);
#if SKV_UNIT == 0
SKV_PART(float, false)
#endif
#if SKV_UNIT == 1
SKV_PART(float, true)
#endif
#if SKV_UNIT == 2
SKV_PART(__nv_bfloat16, false)
#endif
#if SKV_UNIT == 3
SKV_PART(__nv_bfloat16, true)
#endif
#undef SKV_PART

#if SKV_UNIT == 4
namespace {

template <typename QT>
int launch_kv(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
              const void* lengths, const void* entries, const void* ks, const void* vs,
              const float* lut, void* out, int B, int S, int Hkv, int G, int D, int window,
              int is_ring, float scale, int n_split, cudaStream_t st) {
  if (kv_dtype != kF32 && kv_dtype != kBF16 && kv_dtype != kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto part = kv_dtype == kI8 ? launch_part<QT, true> : launch_part<QT, false>;
  return part(kv_dtype, scale_dtype, q, k, v, lengths, entries, ks, vs, lut, out, B, S, Hkv,
              G, D, window, is_ring, scale, n_split, st);
}

template <typename QT>
int occupancy_kv(int kv_dtype, int scale_dtype, int G, int D, int lut, int* out) {
  if (kv_dtype != kF32 && kv_dtype != kBF16 && kv_dtype != kI8)
    return static_cast<int>(cudaErrorInvalidValue);
  return kv_dtype == kI8 ? occupancy_part<QT, true>(kv_dtype, scale_dtype, G, D, lut, out)
                         : occupancy_part<QT, false>(kv_dtype, scale_dtype, G, D, lut, out);
}

// exp_lut() elementwise over n floats (swiftkv_exp_lut_launch)
__global__ void __launch_bounds__(256)
exp_lut_kernel(const float* __restrict__ x, const float* __restrict__ lut,
               float* __restrict__ out, int n) {
  load_lut(lut);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = exp_lut(x[i]);
}

}  // namespace

// q, out: [B, Hkv, G, D] (q_dtype); k, v: [B, S, Hkv, D] (kv_dtype);
// lengths: [B] int32; entries: [B] int32 or null: with entries, k, v are a
// pool [E, S, Hkv, D] (scales [E, Hkv, S]) and row b reads entry
// entries[b] (in [0, E)); k_scale, v_scale: [B, Hkv, S] (scale_dtype) for an
// int8 cache, else null. lut: the LUT form's table [64] (the 32 values of
// make_lut, then its 32 slopes, float32), or null for the native exp.
// dtype codes: 0 f32, 1 bf16, 2 int8. window <= 0 means none. is_ring != 0:
// the caches are rings of S slots (needs a window).
// n_split (1..8): CTAs, one cluster, per (row, KV head).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int swiftkv_decode_launch(const void* q, const void* k, const void* v,
                                     const void* lengths, const void* entries,
                                     const void* k_scale, const void* v_scale,
                                     const float* lut, void* out, int B, int S, int Hkv,
                                     int G, int D, int window,
                                     int is_ring, float scale, int n_split, int q_dtype,
                                     int kv_dtype, int scale_dtype, void* stream) {
  if (G < 1 || G > kMaxG || D < 8 || D > kMaxD || D % 8 != 0 || B < 1 || Hkv < 1 ||
      S < 1 || n_split < 1 || n_split > kMaxSplit || (is_ring && window <= 0) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, scale_dtype, q, k, v, lengths, entries, k_scale,
                            v_scale, lut, out, B, S, Hkv, G, D, window, is_ring, scale,
                            n_split, st);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, scale_dtype, q, k, v, lengths, entries, k_scale,
                                    v_scale, lut, out, B, S, Hkv, G, D, window, is_ring, scale,
                                    n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The occupancy of the kernel that swiftkv_decode_launch takes at (G, D,
// q_dtype, kv_dtype, scale_dtype; lut != 0: the LUT instance), its shared
// memory set as a launch sets it: out[0] =
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, out[n] for n = 1..8 =
// cudaOccupancyMaxActiveClusters with clusters of (1, n, 1) CTAs (out: 9
// ints). Returns the cudaError_t of the queries (0 on success).
extern "C" int swiftkv_decode_occupancy(int G, int D, int q_dtype, int kv_dtype,
                                        int scale_dtype, int lut, int* out) {
  if (G < 1 || G > kMaxG || D < 8 || D > kMaxD || D % 8 != 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == kF32) return occupancy_kv<float>(kv_dtype, scale_dtype, G, D, lut, out);
  if (q_dtype == kBF16)
    return occupancy_kv<__nv_bfloat16>(kv_dtype, scale_dtype, G, D, lut, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[i] = the LUT form's exp(x[i]) for n float32 values; lut as above.
// Test entry: it holds the kernel's exponential to its plain version.
extern "C" int swiftkv_exp_lut_launch(const float* x, const float* lut, float* out, int n,
                                      void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  exp_lut_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, lut, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* swiftkv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // SKV_UNIT == 4
