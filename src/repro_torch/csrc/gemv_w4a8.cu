// W4A8 GEMV/GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gemv_w4a8/kernel.py:
// gemv_w4a8_pallas (body _kernel), together with the per-token activation
// quantization its wrapper runs first (quantize_a8). Same function:
//     out[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * w4[k, n]
// xq: [M, K] int8 activations, quantized per token; packed: [K, N/2]
// uint8, two int4 output channels per byte along N (low nibble = even n),
// sign-extended on unpack; ws: [ceil(K/128), N] f32 group scales; xs: [M]
// f32; out: [M, N] f32. Integer sums inside each 128-channel group (int32,
// exact), f32 across groups. Rows k >= K are masked (the scales cover a
// padded last group).
//
// Both forms run the products on int8 tensor cores (mma.sync m16n8k32)
// with the weight as A and x as B: a lane loads one 32-bit weight word (8
// output channels) of rows t + 4 i (i < 4) of a 16-row block, transposes
// the bytes of each four rows with byte permutes and puts each nibble at
// the top of its byte (16 w, no sign-extension step); byte pair j of the
// word is then the A fragment of one MMA, channel 2j as A row g and 2j + 1
// as A row g + 8. The group sum comes out 16x too large and 1/16 goes into
// the group scale, exactly. x's codes are kept in the same k order (code i
// of each 16-code block in byte i / 4 of word i % 4), so a B fragment is
// one 32-bit load. Two forms, chosen by the wrapper from M:
//
// * gemv_w4a8_decode_kernel, M <= 8 (decode: one row per sequence). Bound
//   by bytes: the packed weight is K N / 2 bytes, read once (llama2-7b's
//   4096 x 11008 projection: ~23 MB, ~7 us at 3.35 TB/s). One launch
//   computes the whole projection from float x, the M <= 8 rows filling
//   the MMA's n = 8:
//   - the grid is (N tiles, ks); the ks CTAs of an N tile split its K
//     groups in order and form one thread-block cluster;
//   - each CTA copies its K slice of x into shared memory (cp.async, ahead
//     of the weights), takes the rows' |x| maxima over it and writes them
//     into every rank's shared memory; after one cluster barrier each rank
//     has the rows' amax and quantizes its own slice as quantize_a8 does,
//     bit for bit, without reading the whole rows. (A slice too long to
//     stage is read in place instead.)
//   - the weight tile streams through a 4-stage cp.async ring of 8 KB
//     stages (16-byte copies, 4-byte where rows are not 16-byte aligned)
//     that starts before x is read, the group scales riding the same
//     stages;
//   - the CTA's warps meet in shared memory; each rank then sends its
//     partial sums of every rank's share of the outputs into that rank's
//     shared memory, and after one cluster barrier adds its share in rank
//     order (no atomics, no workspace, no second launch), so a run repeats
//     itself bit for bit.
//   Each phase before the weight loop runs once per CTA with one warp per
//   scheduler, so those loops are short and stay rolled (PERF.md has the
//   phases' cycle counts).
// * M > 8 (prefill): two launches per projection.
//   - gemv_w4a8_quant: one CTA per row of x takes the row's |x| maximum,
//     its scale and its codes as quantize_a8 does, bit for bit, and writes
//     the codes in the MMA's k order, each row zero-padded to whole
//     128-code groups (so the GEMM copies x by 16 bytes, unmasked along K).
//     Bound by bytes (2-4 B read, 1 B written per element).
//   - gemv_w4a8_kernel: bound by operations (2 M K N int8 operations; at
//     M = 1024, 4096 -> 11008: 92 G, ~47 us at 1979 int8 TOPS, against
//     ~28 MB of operands). A CTA takes 128 output channels x 64 tokens, a
//     warp 64 channels x 32 tokens, so each unpacked A fragment feeds four
//     n8 token tiles and the unpack cost is spread over them. (Two CTAs of
//     four warps per SM ran faster than one of eight, or than narrower
//     tiles that fill more SMs at small M: PERF.md.) The K step is one 128-row group: four k32
//     MMAs per fragment into int32, then one fold into f32 with the group
//     scale / 16. The weight rows, their scales and the x codes of a group
//     stream through a 4-stage cp.async ring (16-byte copies; 4-byte
//     weight copies where rows are not 16-byte aligned), swizzled or padded
//     so that the fragment loads miss no bank. No split of K and no
//     workspace: one CTA owns each output, so a run repeats itself bit for
//     bit. The f32 tile goes out through shared memory in 16-byte stores.
//     (wgmma would need the weight transposed to K-major in shared memory
//     by a converter stage: a later step.)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroup = 128;            // input channels per scale group

// 4x4 byte transpose: out[j].byte(r) = in[r].byte(j)
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           int out[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140);   // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(c, d, 0x7362);   // c2 d2 c3 d3
  out[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));   // a0 b0 c0 d0
  out[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));   // a1 b1 c1 d1
  out[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));   // a2 b2 c2 d2
  out[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));   // a3 b3 c3 d3
}

// ---------------------------------------------------------------------------
// Decode form: M <= 8, activation quantization inside, split-K in a cluster
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kStageBytes = 8192;                     // weight bytes per ring stage
constexpr int kScaleBytes = 1024;                     // group scales per stage
constexpr int kSlotBytes = kStageBytes + kScaleBytes;
constexpr int kStages = 4;                            // ring depth
constexpr int kMaxRanks = 8;                          // CTAs per cluster (portable limit)
constexpr size_t kStageBudget = 160 * 1024;           // x staged only below this much smem
constexpr int kMaxM = 8;

// Built with -DGEMV_DECODE_PHASES (tools/gemv_decode_phases.py), the decode
// kernel writes each CTA's clock at its phase boundaries to xs_out instead
// of the row scales: the phases' cycles, where no profiler reaches.
#ifdef GEMV_DECODE_PHASES
#define DECODE_PHASE(i) phase_clock[i] = clock64()
#else
#define DECODE_PHASE(i)
#endif

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(__cvta_generic_to_global(gmem)), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the cluster barrier, split: every thread of the cluster arrives once and
// then waits once per phase
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// eight consecutive elements of a 16-byte aligned shared-memory row, as f32
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

// The row scale exactly as quantize_a8 (and the reference) computes it:
// torch.where(amax > 0, amax / 127, 1.0) in the input's dtype, by IEEE
// division (div.rn.f32: the build has no fast-math), a bf16 quotient
// rounded to bf16.
template <typename XT>
__device__ __forceinline__ float row_scale(float amax) {
  if (!(amax > 0.f)) return 1.f;
  const float s = amax / 127.f;
  if constexpr (std::is_same<XT, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(s));
  return s;
}

// Sixteen codes clamp(round_half_even(v / sc), -127, 127), as
// quantize_a8 computes them (IEEE division), packed four to a word: code i
// in byte i / 4 of word i % 4 (the MMA's k order, see below).
__device__ __forceinline__ uint4 pack16(const float t[16]) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // t[i] is a whole number of at most ~2^8: its bits + 1.5 * 2^23 hold it
    const int c = max(-127, min(127, __float_as_int(t[i] + 12582912.f) - 0x4B400000));
    w[i & 3] |= (static_cast<uint32_t>(c) & 0xFFu) << (8 * (i >> 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The codes of x[0 : valid] (then 0) by division: out of line, since
// quant16 needs it about once in 10^4 blocks.
template <typename XT>
__device__ __noinline__ uint4 quant16_divide(const XT* x, int valid, float sc) {
  float t[16];
  for (int i = 0; i < 16; ++i) t[i] = rintf(__fdiv_rn(i < valid ? to_f32(x[i]) : 0.f, sc));
  return pack16(t);
}

// The codes of v[16] = x[0 : valid] (then 0). v * (1 / sc) is within 3
// ulp of the quotient; only where that leaves the rounding in doubt
// (within 3e-5 of a half integer, |v / sc| <= ~128) are the divisions
// themselves taken, for the whole block at once, so the common path has
// no branch per code.
template <typename XT>
__device__ __forceinline__ uint4 quant16(const float v[16], const XT* x, int valid, float sc,
                                         float inv) {
  // q + 1.5 * 2^23 rounds q to an integer, half to even (|q| < 2^22),
  // with full-rate adds: no FRND / F2I on the common path
  constexpr float kMagic = 12582912.f;
  float t[16];
  bool doubt = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float q = v[i] * inv;
    t[i] = (q + kMagic) - kMagic;
    doubt |= 0.5f - fabsf(q - t[i]) < 3e-5f;
  }
  return doubt ? quant16_divide(x, valid, sc) : pack16(t);
}

// XOR of a weight word's column in shared memory, by row: 16-byte chunks
// of 128-byte rows move by 2 (row % 4), of 64-byte rows by 2 ((row / 2) %
// 2), so that the four k-lanes of an MMA fragment, reading one column of
// four consecutive rows, hit four different banks. In words.
__device__ __forceinline__ int swizzle(int row, int words_per_row) {
  if (words_per_row == 32) return (row & 3) << 3;
  if (words_per_row == 16) return ((row >> 1) & 1) << 3;
  return 0;
}

// A stage of weight rows [row0, row0 + rows) where rows are not 16-byte
// aligned (N % 32 != 0), by 4-byte copies: out of line, off the path.
__device__ __noinline__ void copy_stage_words(uint8_t* slot, const uint8_t* packed, int row0,
                                              int rows, int tile_b0, int half_n, int wpr) {
  for (int c = threadIdx.x; c < kStageBytes / 4; c += blockDim.x) {
    const int row = c / wpr;
    const int b = tile_b0 + (c % wpr) * 4;
    const bool ok = row < rows && b < half_n;
    const int dst = row * wpr + ((c % wpr) ^ swizzle(row, wpr));
    cp_async4(slot + 4 * dst, ok ? packed + static_cast<size_t>(row0 + row) * half_n + b : packed,
              ok ? 4 : 0);
  }
}

// x's slice into shared memory where it cannot go by 16-byte copies
// (rows not 16-byte aligned): out of line, off the path
template <typename XT>
__device__ __noinline__ void copy_x_slow(const XT* x, XT* x_raw, int M, int K, int k_lo, int sl,
                                         int lay) {
  for (int m = 0; m < M; ++m)
    for (int i = threadIdx.x; i < sl; i += blockDim.x)
      x_raw[m * lay + i] = x[static_cast<size_t>(m) * K + k_lo + i];
}

// One int8 tensor-core product, D[16 x 8] += A[16 x 32] B[32 x 8] (s32).
__device__ __forceinline__ void mma_s8(int d[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Grid (ceil(N / (2 T)), ks), cluster (1, ks, 1), T = tile_bytes of each
// weight row (16, 32, 64 or 128: 32 to 256 output channels). The product
// runs on int8 tensor cores with the weight as A and x as B, so the eight
// rows of x fill the MMA's n = 8: per 32 weight rows, a warp's lane
// (g, t) = (lane / 4, lane % 4) loads one 32-bit word (8 channels) of
// rows t + 4 i and 16 + t + 4 i (i < 4), transposes the bytes of each four
// rows with byte permutes and puts each nibble at the top of its byte
// (16 w); byte pair j of the word is then the A fragment of four MMAs,
// channel 2j as A row g and 2j + 1 as A row g + 8. x is stored in the
// same k order, so a fragment of B is one 32-bit load. The warps of a CTA
// take 32-byte column blocks of the tile and, where the tile has fewer
// than four, rows: a 8 KB ring stage holds SR = 8192 / T rows, each warp
// 64 (128 at T = 16, where lanes g >= 4 have no column and feed zeros)
// within one 128-row group.
template <typename XT>
__global__ void __launch_bounds__(kDecThreads)
gemv_w4a8_decode_kernel(const XT* __restrict__ x,            // [M, K]
                        const uint8_t* __restrict__ packed,  // [K, N/2]
                        const float* __restrict__ ws,        // [>= ceil(K/128), N]
                        float* __restrict__ out,             // [M, N]
                        float* __restrict__ xs_out,          // [M] or null
                        int M, int K, int N, int tile_bytes, int x_staged, int x_vec16,
                        int w_vec16) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float amax_all[kMaxRanks][kMaxM];   // every rank's row maxima, sent by it
  __shared__ float row_max[kMaxM];         // this rank's row maxima
  __shared__ float xs_s[kMaxM];            // the rows' scales, and their reciprocals
  __shared__ float inv_s[kMaxM];

#ifdef GEMV_DECODE_PHASES
  long long phase_clock[6];
#endif
  DECODE_PHASE(0);
  cg::cluster_group cluster = cg::this_cluster();
  // a CTA writes into another's shared memory only once all have started
  cluster_arrive_relaxed();
  const int ks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tnb = tile_bytes;
  const int tn = 2 * tnb;                 // tile output channels
  const int wpr = tnb / 4;                // weight words per tile row
  const int lg_t = __ffs(tnb) - 1;        // log2 of the tile bytes
  const int sr = kStageBytes >> lg_t;     // rows per stage
  const int cb_n = tnb >= 32 ? tnb / 32 : 1;   // 32-byte column blocks
  const int phases = kDecWarps / cb_n;    // warps sharing a column block
  const int wr = sr / phases;             // rows per warp per stage
  const int half_n = N / 2;
  const int tile_b0 = blockIdx.x * tnb;   // first byte of the tile in a row
  const int tile_n0 = blockIdx.x * tn;
  const int n_groups = (K + 127) / 128;
  const int g0 = rank * n_groups / ks;
  const int g1 = (rank + 1) * n_groups / ks;
  const int k_lo = g0 * 128;
  const int k_hi = min(g1 * 128, K);
  const int sl = k_hi - k_lo;             // this rank's K slice
  const int n_stages = (sl + sr - 1) >> (13 - lg_t);
  const int slp = n_stages * sr;          // slice rows padded to whole stages
  // shared-memory layout from the longest slice of the cluster, so that a
  // region lies at the same offset in every rank
  const int lay = ((((n_groups + ks - 1) / ks) * 128 + sr - 1) >> (13 - lg_t)) << (13 - lg_t);
  const int xstride = lay + 16;           // x_s row stride: B loads miss no bank

  uint8_t* ring = smem;
  int8_t* x_s = reinterpret_cast<int8_t*>(smem + kStages * kSlotBytes);   // [8][xstride]
  XT* x_raw = reinterpret_cast<XT*>(x_s + kMaxM * xstride);               // [8][lay] or none
  float* recv = reinterpret_cast<float*>(x_raw + (x_staged ? kMaxM * lay : 0));   // [ks][P]
  // where x's slice is read from: shared memory where it was staged there,
  // else device memory (a slice too long to stage, of 16-byte aligned rows)
  const XT* xsrc = x_staged ? x_raw : x + k_lo;
  const size_t xld = x_staged ? lay : K;

  // stage s: rows [k_lo + s sr, + sr) of the tile (swizzled), and the
  // scales of the groups they touch; rows >= k_hi, channels >= N read as
  // 0. A thread's copies sit at the same places in every stage: their
  // offsets are worked out once, so issuing a stage costs a few adds.
  constexpr int kCopies = kStageBytes / 16 / kDecThreads;   // 16-byte copies per thread
  int cp_row[kCopies], cp_dst[kCopies];
  size_t cp_src[kCopies];
  bool cp_col_ok[kCopies];
  const int cpr_shift = lg_t - 4;        // log2 of the 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = tid + i * kDecThreads;
    const int col = c & ((1 << cpr_shift) - 1);
    cp_row[i] = c >> cpr_shift;
    const int b = tile_b0 + col * 16;
    cp_col_ok[i] = b < half_n;
    cp_dst[i] = 4 * (cp_row[i] * wpr + ((4 * col) ^ swizzle(cp_row[i], wpr)));
    cp_src[i] = static_cast<size_t>(cp_row[i]) * half_n + b;
  }
  const int cpg = tn / 4;                  // 16-byte chunks of scales per group
  const int ws_gi = tid >> (lg_t - 1);     // this thread's scale copy: group, channel
  const int ws_n = tile_n0 + (tid & (cpg - 1)) * 4;
  const int ws_dst = ws_gi * tn + (tid & (cpg - 1)) * 4;
  const int ws_copies = (sr >= 128 ? sr / 128 : 1) * cpg;
  auto issue = [&](int s) {
    uint8_t* slot = ring + (s % kStages) * kSlotBytes;
    const int r0 = s * sr;                 // slice row of the stage's row 0
    if (w_vec16) {
      const uint8_t* src = packed + static_cast<size_t>(k_lo + r0) * half_n;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const bool ok = cp_col_ok[i] && r0 + cp_row[i] < sl;
        cp_async16(slot + cp_dst[i], ok ? src + cp_src[i] : packed, ok ? 16 : 0);
      }
    } else {
      copy_stage_words(slot, packed, k_lo + r0, sl - r0, tile_b0, half_n, wpr);
    }
    if (tid < ws_copies) {
      const int grp = g0 + r0 / 128 + ws_gi;
      const bool ok = grp < g1 && ws_n < N;
      cp_async16(reinterpret_cast<float*>(slot + kStageBytes) + ws_dst,
                 ok ? ws + static_cast<size_t>(grp) * N + ws_n : ws, ok ? 16 : 0);
    }
  };

  // x's slice first (one copy group, ahead of the weights in the memory
  // queues), then the weight ring: the weights do not depend on x
  if (x_staged && x_vec16) {         // sl is then a multiple of V
    constexpr int V = 16 / sizeof(XT);
#pragma unroll 1
    for (int m = 0; m < M; ++m) {
#pragma unroll 1
      for (int c = tid; c < sl / V; c += kDecThreads)
        cp_async16(x_raw + m * lay + c * V, x + static_cast<size_t>(m) * K + k_lo + c * V, 16);
    }
  } else if (x_staged) {
    copy_x_slow(x, x_raw, M, K, k_lo, sl, lay);
  }
  cp_async_commit();
  issue(0);                          // (every slice has a stage)
  cp_async_commit();

  // |x| maxima of the rows over this rank's slice
  cp_async_wait<1>();                // the x group has landed
  __syncthreads();
  // sixteen lanes a row of x, all rows at once (row m in warp m / 2)
  {
    const int m = tid >> 4;
    float a = 0.f;
    if (m < M) {
      if (sl % 8 == 0) {
#pragma unroll 4
        for (int c = tid & 15; c < sl / 8; c += 16) {
          float e[8];
          load8(xsrc + m * xld + 8 * c, e);
#pragma unroll
          for (int j = 0; j < 8; ++j) a = fmaxf(a, fabsf(e[j]));
        }
      } else {
#pragma unroll 4
        for (int i = tid & 15; i < sl; i += 16) a = fmaxf(a, fabsf(to_f32(xsrc[m * xld + i])));
      }
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if ((tid & 15) == 0) row_max[m] = a;
  }
  __syncthreads();
  DECODE_PHASE(1);                   // x copied, this rank's maxima taken
  // every rank's maxima -> the rows' amax (a max: any order gives the
  // same): each rank writes its maxima into every rank's shared memory
  cluster_wait();                    // (the start guard)
  if (tid < kMaxM * kMaxRanks) {
    const int m = tid % kMaxM;
    const int r = tid / kMaxM;
    if (r < ks) *cluster.map_shared_rank(&amax_all[rank][m], r) = row_max[m];
  }
  cluster_arrive();
  // the rest of the ring's first stages while the other ranks catch up
#pragma unroll 1
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < n_stages) issue(s);
    cp_async_commit();
  }
  cluster_wait();
  if (tid < kMaxM) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r)
      if (r < ks) a = fmaxf(a, amax_all[r][tid]);
    const float sc = row_scale<XT>(a);
    xs_s[tid] = sc;
    inv_s[tid] = 1.f / sc;
#ifndef GEMV_DECODE_PHASES
    if (xs_out != nullptr && blockIdx.x == 0 && rank == 0 && tid < M) xs_out[tid] = sc;
#endif
  }
  __syncthreads();
  DECODE_PHASE(2);                   // the rows' scales known

  // int8 codes of the slice into x_s in the MMA's k order: word a of each
  // 16-row block holds rows a, a + 4, a + 8, a + 12 (a B fragment is one
  // 32-bit load), so a thread quantizes one block of one row of x and
  // stores its 16 codes at once; rows of x past M and slice rows past sl
  // get code 0
  const int blocks = slp / 16;
#pragma unroll 2
  for (int it = tid; it < kMaxM * blocks; it += kDecThreads) {
    const int m = it / blocks;
    const int r = (it - m * blocks) * 16;
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
    if (m < M) {
      constexpr int V = 16 / sizeof(XT);
      const XT* xr = xsrc + m * xld + r;
      if (x_vec16) {                 // whole 16-byte chunks, none past sl
#pragma unroll
        for (int c = 0; c < 16 / V; ++c) {
          if (r + c * V < sl) {
            const uint4 u = reinterpret_cast<const uint4*>(xr)[c];
            const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
            for (int j = 0; j < V; ++j) v[c * V + j] = to_f32(e[j]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r + i < sl) v[i] = to_f32(xr[i]);
      }
    }
    *reinterpret_cast<uint4*>(x_s + m * xstride + r) =
        quant16(v, xsrc + m * xld + r, sl - r, xs_s[m], inv_s[m]);
  }

  DECODE_PHASE(3);                   // the slice quantized (by this thread)
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cb = warp % cb_n;
  const int phase = warp / cb_n;
  const int cw = cb * 8 + g;              // this lane's column word of the tile
  const bool live = cw < wpr;             // false only for g >= 4 at T = 16
  const int cws = cw ^ swizzle(t, wpr);   // where it lies in rows t (mod 4)
  int acc[4][4];
  float accf[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0;
      accf[j][e] = 0.f;
    }

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // stage s landed; stage s - 1 is free
    if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
    cp_async_commit();
    const uint8_t* slot = ring + (s % kStages) * kSlotBytes;
    const int row0 = phase * wr;     // this warp's first row in the stage
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(slot) + (row0 + t) * wpr + cws;
    const int8_t* xp = x_s + g * xstride + s * sr + row0 + 4 * t;
    for (int q = 0; q < wr; q += 32) {
      uint32_t w[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[u][i] = live ? wp[(q + 16 * u + 4 * i) * wpr] : 0u;
      const int b0 = *reinterpret_cast<const int*>(xp + q);
      const int b1 = *reinterpret_cast<const int*>(xp + q + 16);
      int tr[2][4];
      transpose4(w[0][0], w[0][1], w[0][2], w[0][3], tr[0]);
      transpose4(w[1][0], w[1][1], w[1][2], w[1][3], tr[1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo0 = (static_cast<uint32_t>(tr[0][j]) << 4) & 0xF0F0F0F0u;
        const uint32_t hi0 = static_cast<uint32_t>(tr[0][j]) & 0xF0F0F0F0u;
        const uint32_t lo1 = (static_cast<uint32_t>(tr[1][j]) << 4) & 0xF0F0F0F0u;
        const uint32_t hi1 = static_cast<uint32_t>(tr[1][j]) & 0xF0F0F0F0u;
        mma_s8(acc[j], static_cast<int>(lo0), static_cast<int>(hi0), static_cast<int>(lo1),
               static_cast<int>(hi1), b0, b1);
      }
    }
    // the warp's group ends here: fold its int sums into f32 with the
    // group scales / 16 (exact: a power of two)
    const int row = s * sr + row0;
    if (s == n_stages - 1 || ((row + sr) >> 7) != (row >> 7)) {
      if (live) {
        const float* wsl = reinterpret_cast<const float*>(slot + kStageBytes) +
                           ((row >> 7) - ((s * sr) >> 7)) * tn + 8 * cw;
        const float4 s0 = *reinterpret_cast<const float4*>(wsl);
        const float4 s1 = *reinterpret_cast<const float4*>(wsl + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            accf[j][e] = fmaf(static_cast<float>(acc[j][e]), sc[2 * j + (e >> 1)] * 0.0625f,
                              accf[j][e]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    }
  }
  cp_async_wait<0>();
  DECODE_PHASE(4);                   // the weight loop done

  // the warps of a column block, through shared memory, in phase order
  __syncthreads();                   // every warp is done with the ring
  float* red = reinterpret_cast<float*>(ring);   // [phases][8 rows of x][tn]
  if (live) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)   // D: (channel 2j + e / 2, row 2t + e % 2)
        red[(phase * kMaxM + 2 * t + (e & 1)) * tn + 8 * cw + 2 * j + (e >> 1)] = accf[j][e];
  }
  __syncthreads();
  // the ranks share the merge: rank r owns outputs [r P, (r + 1) P) of
  // the tile (P = per_rank); every rank sends its partial sums of them
  // into the owner's shared memory, and after one cluster barrier the
  // owner adds them in rank order and scales by xs
  const int n_out = M * tn;
  const int per_rank = (n_out + ks - 1) / ks;
  int owner = tid / per_rank;
#pragma unroll 4
  for (int e = tid; e < n_out; e += kDecThreads) {
    float v = red[e];
    for (int p = 1; p < phases; ++p) v += red[p * kMaxM * tn + e];
    while (e >= (owner + 1) * per_rank) ++owner;
    *cluster.map_shared_rank(recv + rank * per_rank + e - owner * per_rank, owner) = v;
  }
  cluster_arrive();
  cluster_wait();
#pragma unroll 1
  for (int i = tid; i < per_rank; i += kDecThreads) {
    const int e = rank * per_rank + i;
    const int m = e / tn;
    const int n = tile_n0 + e - m * tn;
    if (e >= n_out || n >= N) continue;
    float v = recv[i];
#pragma unroll
    for (int r = 1; r < kMaxRanks; ++r)
      if (r < ks) v += recv[r * per_rank + i];
    out[static_cast<size_t>(m) * N + n] = v * xs_s[m];
  }
#ifdef GEMV_DECODE_PHASES
  DECODE_PHASE(5);                   // merged and written
  if (tid == 0 && xs_out != nullptr) {
    long long* d = reinterpret_cast<long long*>(xs_out) + 6 * (blockIdx.y * gridDim.x + blockIdx.x);
    for (int i = 0; i < 6; ++i) d[i] = phase_clock[i] - phase_clock[0];
  }
#endif
}

template <typename XT>
int launch_decode(const void* x, const void* packed, const void* ws, void* out, void* xs_out,
                  int M, int K, int N, int tile_bytes, int ks, cudaStream_t stream) {
  auto kernel = gemv_w4a8_decode_kernel<XT>;
  const int sr = kStageBytes / tile_bytes;
  const int n_groups = (K + 127) / 128;
  const int max_slice = ((n_groups + ks - 1) / ks) * 128;
  const int max_stages = (max_slice + sr - 1) / sr;
  const int x_vec16 = (static_cast<size_t>(K) * sizeof(XT)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // x's slice is staged in shared memory unless that would pass the
  // budget; then, where its rows are 16-byte aligned, it is read in place
  const size_t fixed = static_cast<size_t>(kStages) * kSlotBytes +
                       static_cast<size_t>(kMaxM) * (max_stages * sr + 16) +
                       (static_cast<size_t>(kMaxM) * 2 * tile_bytes + kMaxRanks) * sizeof(float);
  const size_t staged = static_cast<size_t>(kMaxM) * max_stages * sr * sizeof(XT);
  const int x_staged = !x_vec16 || fixed + staged <= kStageBudget;
  const size_t smem = fixed + (x_staged ? staged : 0);
  static size_t smem_allowed = 0;    // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const int w_vec16 = N % 32 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 2 * tile_bytes - 1) / (2 * tile_bytes), ks);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const XT*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(ws), static_cast<float*>(out), static_cast<float*>(xs_out), M,
      K, N, tile_bytes, x_staged, x_vec16, w_vec16);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}


// ---------------------------------------------------------------------------
// Prefill form: M > 8, quantization in its own kernel, then the GEMM
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;

// One CTA per row of x: the row's |x| maximum, its scale (row_scale) into
// xs, then its codes 16 at a time (quant16: bit for bit quantize_a8's) in
// the MMA's k order, the row padded with code 0 to kp (K rounded up to a
// whole 128-row group).
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
gemv_w4a8_quant(const XT* __restrict__ x,        // [M, K]
                int8_t* __restrict__ codes,      // [M, kp]
                float* __restrict__ xs,          // [M]
                int K, int kp, int x_vec16) {
  constexpr int V = 16 / sizeof(XT);
  __shared__ float warp_max[kQuantThreads / 32];
  const int tid = threadIdx.x;
  const XT* xr = x + static_cast<size_t>(blockIdx.x) * K;
  float a = 0.f;
  if (x_vec16) {
    for (int c = tid; c < K / V; c += kQuantThreads) {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[c];
      const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) a = fmaxf(a, fabsf(to_f32(e[j])));
    }
  } else {
    for (int i = tid; i < K; i += kQuantThreads) a = fmaxf(a, fabsf(to_f32(xr[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = a;
  __syncthreads();
  a = 0.f;
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) a = fmaxf(a, warp_max[w]);
  const float sc = row_scale<XT>(a);
  const float inv = 1.f / sc;
  if (tid == 0) xs[blockIdx.x] = sc;
  int8_t* cr = codes + static_cast<size_t>(blockIdx.x) * kp;
  for (int b = tid; b < kp / 16; b += kQuantThreads) {
    const int k0 = 16 * b;
    float v[16];
    if (x_vec16 && k0 + 16 <= K) {
#pragma unroll
      for (int c = 0; c < 16 / V; ++c) {
        const uint4 u = reinterpret_cast<const uint4*>(xr + k0)[c];
        const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j) v[c * V + j] = to_f32(e[j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = k0 + i < K ? to_f32(xr[k0 + i]) : 0.f;
    }
    *reinterpret_cast<uint4*>(cr + k0) = quant16(v, xr + k0, K - k0, sc, inv);
  }
}

constexpr int kPreStages = 4;            // cp.async ring depth
constexpr int kXRow = kGroup + 16;       // x tile row stride (bytes): B loads miss no bank

// A CTA of 2 x 2 warps takes 128 output channels x 64 tokens. Two such
// CTAs share an SM (registers), so one's barriers and epilogue overlap
// the other's loop.
constexpr int kPreWN = 2;                // warps along N, 64 channels each
constexpr int kPreWM = 2;                // warps along M, 32 tokens each
constexpr int kPreThreads = 32 * kPreWN * kPreWM;
constexpr int kPreBN = 64 * kPreWN;
constexpr int kPreBM = 32 * kPreWM;
constexpr int kPreTB = kPreBN / 2;       // weight bytes of a tile row
constexpr int kPreWPR = kPreTB / 4;      // weight words of a tile row
constexpr int kPreW = kGroup * kPreTB;   // a stage: the group's weight rows,
constexpr int kPreS = kPreBN * 4;        // their scales,
constexpr int kPreX = kPreBM * kXRow;    // the tokens' codes
constexpr int kPreSlot = kPreW + kPreS + kPreX;
constexpr int kOutRow = kPreBN + 4;      // f32 out tile row stride
constexpr int kPreSmem = kPreStages * kPreSlot > kPreBM * kOutRow * 4
                             ? kPreStages * kPreSlot : kPreBM * kOutRow * 4;

// Grid (ceil(N / 128), ceil(M / 64)). Warp (wn, wm) owns channels
// [64 wn, + 64) and tokens [32 wm, + 32) of the tile: lane (g, t) =
// (lane / 4, lane % 4) loads weight word cw = 8 wn + g (channels 8 cw ..
// 8 cw + 7) and the B fragments of tokens 32 wm + 8 nt + g (nt < 4);
// acc[j][nt] is the MMA of channels 8 cw + 2j (+ 1) x tokens 8 nt + 2t (+ 1).
__global__ void __launch_bounds__(kPreThreads)
gemv_w4a8_kernel(const int8_t* __restrict__ xq,       // [M, kp], MMA k order
                 const uint8_t* __restrict__ packed,  // [K, N/2]
                 const float* __restrict__ xs,        // [M]
                 const float* __restrict__ ws,        // [>= kp / 128, N]
                 float* __restrict__ out,             // [M, N]
                 int M, int K, int N, int kp, int w_vec16) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = warp % kPreWN;
  const int wm = warp / kPreWN;
  const int n0 = blockIdx.x * kPreBN;
  const int m0 = blockIdx.y * kPreBM;
  const int half_n = N / 2;
  const int tile_b0 = blockIdx.x * kPreTB;
  const int n_groups = kp / kGroup;

  // stage of group grp: weight rows [128 grp, + 128) of the tile
  // (swizzled; rows >= K, channels >= N read as 0), their scales, and the
  // tile's tokens' codes (tokens >= M read as 0)
  auto issue = [&](int grp) {
    uint8_t* slot = smem + (grp % kPreStages) * kPreSlot;
    const int k0 = grp * kGroup;
    if (w_vec16) {
      constexpr int kCpr = kPreTB / 16;           // 16-byte chunks of a row
#pragma unroll
      for (int i = 0; i < kPreW / 16 / kPreThreads; ++i) {
        const int c = tid + i * kPreThreads;
        const int row = c / kCpr;
        const int b = tile_b0 + (c % kCpr) * 16;
        const bool ok = k0 + row < K && b < half_n;
        cp_async16(slot + 4 * (row * kPreWPR + ((4 * (c % kCpr)) ^ swizzle(row, kPreWPR))),
                   ok ? packed + static_cast<size_t>(k0 + row) * half_n + b : packed,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int c = tid; c < kPreW / 4; c += kPreThreads) {
        const int row = c / kPreWPR;
        const int b = tile_b0 + (c % kPreWPR) * 4;
        const bool ok = k0 + row < K && b < half_n;
        cp_async4(slot + 4 * (row * kPreWPR + ((c % kPreWPR) ^ swizzle(row, kPreWPR))),
                  ok ? packed + static_cast<size_t>(k0 + row) * half_n + b : packed,
                  ok ? 4 : 0);
      }
    }
    if (tid < kPreBN / 4) {
      const int n = n0 + 4 * tid;
      const bool ok = n < N;                     // N % 8 == 0: all 4 or none
      cp_async16(slot + kPreW + 16 * tid, ok ? ws + static_cast<size_t>(grp) * N + n : ws,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kPreBM * 8 / kPreThreads; ++i) {
      const int c = tid + i * kPreThreads;
      const int row = c >> 3;
      const bool ok = m0 + row < M;
      cp_async16(slot + kPreW + kPreS + row * kXRow + (c & 7) * 16,
                 ok ? xq + static_cast<size_t>(m0 + row) * kp + k0 + (c & 7) * 16 : xq,
                 ok ? 16 : 0);
    }
  };

  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = wn * 8 + g;
  const int cws = cw ^ swizzle(t, kPreWPR);   // where it lies in rows t (mod 4)
  int acc[4][4][4];
  float accf[4][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][nt][e] = 0;
        accf[j][nt][e] = 0.f;
      }

#pragma unroll 1
  for (int s = 0; s < kPreStages - 1; ++s) {
    if (s < n_groups) issue(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int grp = 0; grp < n_groups; ++grp) {
    cp_async_wait<kPreStages - 2>();
    __syncthreads();                 // group grp landed; grp - 1's slot is free
    if (grp + kPreStages - 1 < n_groups) issue(grp + kPreStages - 1);
    cp_async_commit();
    const uint8_t* slot = smem + (grp % kPreStages) * kPreSlot;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(slot) + t * kPreWPR + cws;
    const int8_t* xp = reinterpret_cast<const int8_t*>(slot + kPreW + kPreS) +
                       (wm * 32 + g) * kXRow + 4 * t;
#pragma unroll
    for (int q = 0; q < kGroup; q += 32) {
      int b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt][0] = *reinterpret_cast<const int*>(xp + nt * 8 * kXRow + q);
        b[nt][1] = *reinterpret_cast<const int*>(xp + nt * 8 * kXRow + q + 16);
      }
      uint32_t w[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) w[u][i] = wp[(q + 16 * u + 4 * i) * kPreWPR];
      int tr[2][4];
      transpose4(w[0][0], w[0][1], w[0][2], w[0][3], tr[0]);
      transpose4(w[1][0], w[1][1], w[1][2], w[1][3], tr[1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lo0 = static_cast<int>((static_cast<uint32_t>(tr[0][j]) << 4) & 0xF0F0F0F0u);
        const int hi0 = static_cast<int>(static_cast<uint32_t>(tr[0][j]) & 0xF0F0F0F0u);
        const int lo1 = static_cast<int>((static_cast<uint32_t>(tr[1][j]) << 4) & 0xF0F0F0F0u);
        const int hi1 = static_cast<int>(static_cast<uint32_t>(tr[1][j]) & 0xF0F0F0F0u);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[j][nt], lo0, hi0, lo1, hi1, b[nt][0], b[nt][1]);
      }
    }
    // the group ends: fold the int sums into f32 with the group scales / 16
    // (exact: a power of two)
    const float* sp = reinterpret_cast<const float*>(slot + kPreW) + 8 * cw;
    const float4 s0 = reinterpret_cast<const float4*>(sp)[0];
    const float4 s1 = reinterpret_cast<const float4*>(sp)[1];
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          accf[j][nt][e] = fmaf(static_cast<float>(acc[j][nt][e]), sc[2 * j + (e >> 1)] * 0.0625f,
                                accf[j][nt][e]);
          acc[j][nt][e] = 0;
        }
  }
  cp_async_wait<0>();
  __syncthreads();                   // every warp is done with the ring

  // out = xs * sum, through shared memory, then 16-byte stores by rows
  float* ot = reinterpret_cast<float*>(smem);   // [BM][kOutRow]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + nt * 8 + 2 * t + h;
      const float x_scale = m0 + row < M ? xs[m0 + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(ot + row * kOutRow + 8 * cw + 2 * j) =
            make_float2(accf[j][nt][h] * x_scale, accf[j][nt][2 + h] * x_scale);
    }
  __syncthreads();
  constexpr int kC4 = kPreBN / 4;
#pragma unroll 4
  for (int c = tid; c < kPreBM * kC4; c += kPreThreads) {
    const int row = c / kC4;
    const int col = (c % kC4) * 4;
    const int m = m0 + row;
    const int n = n0 + col;
    if (m < M && n < N)              // N % 8 == 0: all 4 or none
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) =
          *reinterpret_cast<const float4*>(ot + row * kOutRow + col);
  }
}

}  // namespace

// x: [M, K] f32 (x_dtype 0) or bf16 (1); codes: [M, kp] int8 with kp = K
// rounded up to a multiple of 128, 16-byte aligned; xs: [M] f32. Writes
// quantize_a8's scales into xs and its codes, in the MMA's k order and
// zero-padded, into codes. Returns the cudaError_t of the launch.
extern "C" int gemv_w4a8_quant_launch(const void* x, void* codes, void* xs, int M, int K,
                                      int kp, int x_dtype, void* stream) {
  if (M < 1 || K < 1 || kp != (K + kGroup - 1) / kGroup * kGroup ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = static_cast<size_t>(K) * (x_dtype == 0 ? 4 : 2);
  const int x_vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_dtype == 0)
    gemv_w4a8_quant<float><<<M, kQuantThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(codes), static_cast<float*>(xs), K,
        kp, x_vec16);
  else if (x_dtype == 1)
    gemv_w4a8_quant<__nv_bfloat16><<<M, kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(codes),
        static_cast<float*>(xs), K, kp, x_vec16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// codes: [M, kp] int8 from gemv_w4a8_quant_launch; packed: [K, N/2] uint8;
// xs: [M] f32; ws: [kp / 128, N] f32; out: [M, N] f32. N must be a
// multiple of 8, packed 4-byte and codes, ws, out 16-byte aligned. Returns
// the cudaError_t of the launch.
extern "C" int gemv_w4a8_launch(const void* codes, const void* packed, const void* xs,
                                const void* ws, void* out, int M, int K, int N, int kp,
                                void* stream) {
  if (M < 1 || K < 1 || N < 8 || N % 8 != 0 || kp != (K + kGroup - 1) / kGroup * kGroup ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_w4a8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPreSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int w_vec16 = N % 32 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const dim3 grid((N + kPreBN - 1) / kPreBN, (M + kPreBM - 1) / kPreBM);
  gemv_w4a8_kernel<<<grid, kPreThreads, kPreSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(xs), static_cast<const float*>(ws), static_cast<float*>(out), M,
      K, N, kp, w_vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gemv_w4a8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] f32 (x_dtype 0) or bf16 (1), M <= 8; packed: [K, N/2] uint8;
// ws: [ceil(K/128), N] f32; out: [M, N] f32; xs_out: [M] f32 (the row
// scales the kernel quantized with) or null. tile_bytes (16, 32, 64, 128:
// weight bytes of a row per CTA) and ks (1..8 CTAs along K, one cluster,
// at most one per 128-row group) set the grid. N must be a multiple of 8
// and ws 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int gemv_w4a8_decode_launch(const void* x, const void* packed, const void* ws,
                                       void* out, void* xs_out, int M, int K, int N,
                                       int x_dtype, int tile_bytes, int ks, void* stream) {
  const int n_groups = (K + 127) / 128;
  if (M < 1 || M > kMaxM || K < 1 || N < 8 || N % 8 != 0 || ks < 1 || ks > kMaxRanks ||
      ks > n_groups || (tile_bytes != 16 && tile_bytes != 32 && tile_bytes != 64 &&
                        tile_bytes != 128) ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 || reinterpret_cast<uintptr_t>(packed) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_decode<float>(x, packed, ws, out, xs_out, M, K, N, tile_bytes, ks, st);
  if (x_dtype == 1)
    return launch_decode<__nv_bfloat16>(x, packed, ws, out, xs_out, M, K, N, tile_bytes, ks,
                                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}
