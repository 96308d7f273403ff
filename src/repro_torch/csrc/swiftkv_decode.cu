// SwiftKV single-pass decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swiftkv_decode/kernel.py:
// swiftkv_decode_pallas (body _kernel). Same function: one query token per
// (row, query head) against a KV cache in its native [B, S, Hkv, D] layout,
// folded in ONE pass with the running triple (mu, Z, Y):
//     mu' = max(mu, max_t s_t)
//     Z, Y <- e^(mu - mu') (Z, Y) + sum_t e^(s_t - mu') (1, v_t)
// and one deferred division at the end; a row with Z == 0 (no valid
// position) writes an exact 0. The G = Hq / Hkv query heads of a KV head
// share every K/V read. Positions outside [lo, len) are never loaded, with
// len = min(lengths[b], S) and lo = max(0, len - window) when a window is
// given. int8 caches carry per-position scales [B, Hkv, S] (f32 or bf16)
// that are multiplied in as the tile is widened to f32.
//
// Bound on an H100: bytes. Each (row, KV head) reads len x D elements of K
// and of V once; the arithmetic is ~4 G D flops per position, far below
// the card's ~295 flops per byte. At llama2-7b decode (B = 8, Hkv = 32,
// D = 128, len ~ 576, bf16) that is ~75 MB per layer, ~22 us at 3.35 TB/s;
// an int8 cache halves it.
//
// Design against that bound: one 128-thread CTA per (row, KV head), so the
// cache is streamed exactly once and the G query heads reuse each tile
// from shared memory; 16-byte vector loads of whole cache rows; positions
// past the prefix are skipped, not masked after loading. What it does not
// do yet: overlap the next tile's loads with the current tile's math
// (cp.async / TMA double buffering), or split S across CTAs and merge the
// partial (mu, Z, Y) states (state_merge) to fill all 132 SMs at small
// B x Hkv — the next steps (ROADMAP §2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // KV positions per shared-memory tile
constexpr int kLoadUnroll = 4;            // vector loads in flight per thread
constexpr int kMaxG = 8;                  // query heads per KV head
constexpr int kMaxD = 256;                // head dim
constexpr int kMaxPerThread = kMaxG * kMaxD / kThreads;   // Y elements per thread
constexpr int kGroupsPerWarp = (kMaxG + kWarps - 1) / kWarps;
constexpr float kNegInf = -1e30f;         // the reference's NEG_INF
static_assert(kTile == 64, "the stats step reads two positions per lane");

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Eight consecutive elements as raw bytes (one vector load), then widened
// to f32. The caller guarantees 8-element alignment (D % 8 == 0 and an
// aligned base pointer). Loads and widening are split so that a thread can
// have several loads in flight before it waits on the first.
template <typename T> struct Raw8;
template <> struct Raw8<float> { float4 a, b; };
template <> struct Raw8<__nv_bfloat16> { uint4 u; };
template <> struct Raw8<int8_t> { uint2 u; };

__device__ __forceinline__ Raw8<float> load8(const float* p) {
  return {reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Raw8<int8_t> load8(const int8_t* p) {
  return {*reinterpret_cast<const uint2*>(p)};
}

__device__ __forceinline__ void widen(const Raw8<float>& r, float out[8]) {
  out[0] = r.a.x; out[1] = r.a.y; out[2] = r.a.z; out[3] = r.a.w;
  out[4] = r.b.x; out[5] = r.b.y; out[6] = r.b.z; out[7] = r.b.w;
}
__device__ __forceinline__ void widen(const Raw8<__nv_bfloat16>& r, float out[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen(const Raw8<int8_t>& r, float out[8]) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&r.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared memory (dynamic, f32): q [G][D] | k [kTile][D] | v [kTile][D] |
// p [G][kTile] | alpha [kMaxG] | z [kMaxG]
__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D + 2 * static_cast<size_t>(kTile) * D +
         static_cast<size_t>(G) * kTile + 2 * kMaxG;
}

// ST (scale type) is read only when the cache is int8 (k_scale != nullptr).
template <typename QT, typename KT, typename ST>
__global__ void __launch_bounds__(kThreads)
swiftkv_decode_kernel(const QT* __restrict__ q,         // [B, Hkv, G, D]
                      const KT* __restrict__ k,         // [B, S, Hkv, D]
                      const KT* __restrict__ v,         // [B, S, Hkv, D]
                      const int* __restrict__ lengths,  // [B]
                      const ST* __restrict__ k_scale,   // [B, Hkv, S] or null
                      const ST* __restrict__ v_scale,   // [B, Hkv, S] or null
                      QT* __restrict__ out,             // [B, Hkv, G, D]
                      int S, int Hkv, int G, int D, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTile * D;
  float* p_s = v_s + kTile * D;
  float* alpha_s = p_s + G * kTile;
  float* z_s = alpha_s + kMaxG;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;

  const int len = max(0, min(lengths[b], S));
  const int lo = window > 0 ? max(0, len - window) : 0;

  const QT* qb = q + static_cast<size_t>(b * Hkv + h) * GD;
  for (int e = tid; e < GD; e += kThreads) q_s[e] = to_f32(qb[e]) * scale;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;   // between positions
  const size_t head_off = static_cast<size_t>(b) * S * row_stride +
                          static_cast<size_t>(h) * D;
  const KT* kb = k + head_off;
  const KT* vb = v + head_off;
  const ST* ksb = k_scale ? k_scale + static_cast<size_t>(b * Hkv + h) * S : nullptr;
  const ST* vsb = v_scale ? v_scale + static_cast<size_t>(b * Hkv + h) * S : nullptr;

  // (mu, Z) of the query rows g = warp + i * kWarps live in that warp's
  // registers (replicated across its lanes); Y is spread over all threads.
  float mu_r[kGroupsPerWarp], z_r[kGroupsPerWarp];
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) { mu_r[i] = kNegInf; z_r[i] = 0.f; }
  float y_r[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) y_r[j] = 0.f;

  const int vec_per_row = D / 8;
  for (int t0 = lo; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    __syncthreads();   // the previous tile's readers are done with k_s / v_s / p_s

    // 1. load the tile, kLoadUnroll vectors of K and of V in flight per
    //    thread; rows past n are zero-filled, never read from memory
    const int n_vec = kTile * vec_per_row;
    for (int e0 = tid; e0 < n_vec; e0 += kThreads * kLoadUnroll) {
      Raw8<KT> kr[kLoadUnroll], vr[kLoadUnroll];
      float ks[kLoadUnroll], vs[kLoadUnroll];
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int e = e0 + u * kThreads;
        const int r = e / vec_per_row;
        if (e < n_vec && r < n) {
          const size_t off =
              static_cast<size_t>(t0 + r) * row_stride + (e - r * vec_per_row) * 8;
          kr[u] = load8(kb + off);
          vr[u] = load8(vb + off);
          if (ksb != nullptr) {
            ks[u] = to_f32(ksb[t0 + r]);
            vs[u] = to_f32(vsb[t0 + r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n_vec) break;
        const int r = e / vec_per_row;
        const int c = (e - r * vec_per_row) * 8;
        float kv[8], vv[8];
        if (r < n) {
          widen(kr[u], kv);
          widen(vr[u], vv);
          if (ksb != nullptr) {
#pragma unroll
            for (int i = 0; i < 8; ++i) { kv[i] *= ks[u]; vv[i] *= vs[u]; }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) { kv[i] = 0.f; vv[i] = 0.f; }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          k_s[r * D + c + i] = kv[i];
          v_s[r * D + c + i] = vv[i];
        }
      }
    }
    __syncthreads();

    // 2. scores s[g][r] = q_g . k_r (q pre-scaled); a warp per position,
    //    lanes split D and reduce by shuffles
    for (int r = warp; r < kTile; r += kWarps) {
      float acc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
      if (r < n) {
        for (int d = lane; d < D; d += 32) {
          const float kd = k_s[r * D + d];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g] += q_s[g * D + d] * kd;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float s = warp_sum(acc[g]);
          if (lane == 0) p_s[g * kTile + r] = r < n ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // 3. fold the tile into (mu, Z): a warp per query row, a lane per two
    //    positions; p_s becomes e^(s - mu') (0 past n)
#pragma unroll
    for (int i = 0; i < kGroupsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {
        const float s0 = p_s[g * kTile + lane];
        const float s1 = p_s[g * kTile + lane + 32];
        const float mu_new = fmaxf(mu_r[i], warp_max(fmaxf(s0, s1)));
        const float alpha = expf(mu_r[i] - mu_new);
        const float e0 = lane < n ? expf(s0 - mu_new) : 0.f;
        const float e1 = lane + 32 < n ? expf(s1 - mu_new) : 0.f;
        p_s[g * kTile + lane] = e0;
        p_s[g * kTile + lane + 32] = e1;
        z_r[i] = alpha * z_r[i] + warp_sum(e0 + e1);
        mu_r[i] = mu_new;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // 4. Y[g][d] <- alpha_g Y[g][d] + sum_r p[g][r] v[r][d]
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < GD) {
        const int g = e / D;
        const int d = e - g * D;
        float acc = 0.f;
        for (int r = 0; r < n; ++r) acc += p_s[g * kTile + r] * v_s[r * D + d];
        y_r[j] = alpha_s[g] * y_r[j] + acc;
      }
    }
  }

  // the one deferred division; Z == 0 (no valid position) gives an exact 0
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < G && lane == 0) z_s[g] = z_r[i];
  }
  __syncthreads();
  QT* ob = out + static_cast<size_t>(b * Hkv + h) * GD;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < GD) {
      const float z = z_s[e / D];
      store(ob + e, z > 0.f ? y_r[j] / z : 0.f);
    }
  }
}

template <typename QT, typename KT, typename ST>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* k_scale, const void* v_scale, void* out, int B, int S,
           int Hkv, int G, int D, int window, float scale, cudaStream_t stream) {
  auto kernel = swiftkv_decode_kernel<QT, KT, ST>;
  const size_t smem = smem_floats(G, D) * sizeof(float);
  static size_t smem_allowed = 48 * 1024;   // per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const int*>(lengths), static_cast<const ST*>(k_scale),
      static_cast<const ST*>(v_scale), static_cast<QT*>(out), S, Hkv, G, D, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_scale(int scale_dtype, const void* q, const void* k, const void* v,
                 const void* lengths, const void* ks, const void* vs, void* out, int B,
                 int S, int Hkv, int G, int D, int window, float scale, cudaStream_t st) {
  if (scale_dtype == kBF16)
    return launch<QT, KT, __nv_bfloat16>(q, k, v, lengths, ks, vs, out, B, S, Hkv, G, D,
                                         window, scale, st);
  return launch<QT, KT, float>(q, k, v, lengths, ks, vs, out, B, S, Hkv, G, D, window,
                               scale, st);
}

template <typename QT>
int launch_kv(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
              const void* lengths, const void* ks, const void* vs, void* out, int B, int S,
              int Hkv, int G, int D, int window, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float, float>(q, k, v, lengths, nullptr, nullptr, out, B, S, Hkv,
                                      G, D, window, scale, st);
    case kBF16:
      return launch<QT, __nv_bfloat16, float>(q, k, v, lengths, nullptr, nullptr, out, B,
                                              S, Hkv, G, D, window, scale, st);
    case kI8:
      return launch_scale<QT, int8_t>(scale_dtype, q, k, v, lengths, ks, vs, out, B, S,
                                      Hkv, G, D, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: [B, Hkv, G, D] (q_dtype); k, v: [B, S, Hkv, D] (kv_dtype);
// lengths: [B] int32; k_scale, v_scale: [B, Hkv, S] (scale_dtype) for an
// int8 cache, else null. dtype codes: 0 f32, 1 bf16, 2 int8. window <= 0
// means none. Returns the cudaError_t of the launch (0 on success).
extern "C" int swiftkv_decode_launch(const void* q, const void* k, const void* v,
                                     const void* lengths, const void* k_scale,
                                     const void* v_scale, void* out, int B, int S,
                                     int Hkv, int G, int D, int window, float scale,
                                     int q_dtype, int kv_dtype, int scale_dtype,
                                     void* stream) {
  if (G < 1 || G > kMaxG || D < 8 || D > kMaxD || D % 8 != 0 || B < 1 || Hkv < 1 ||
      S < 1 || (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return launch_kv<float>(kv_dtype, scale_dtype, q, k, v, lengths, k_scale, v_scale, out,
                            B, S, Hkv, G, D, window, scale, st);
  if (q_dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_dtype, scale_dtype, q, k, v, lengths, k_scale,
                                    v_scale, out, B, S, Hkv, G, D, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* swiftkv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
