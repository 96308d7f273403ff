// W4A8 GEMV/GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gemv_w4a8/kernel.py:
// gemv_w4a8_pallas (body _kernel). Same function:
//     out[m, n] = xs[m] * sum_g ws[g, n] * sum_{k in g} xq[m, k] * w4[k, n]
// xq: [M, K] int8 activations (quantized per token by the wrapper);
// packed: [K, N/2] uint8, two int4 output channels per byte along N (low
// nibble = even n), sign-extended on unpack; ws: [ceil(K/128), N] f32
// group scales; xs: [M] f32; out: [M, N] f32. Integer sums inside each
// 128-channel group (int32, exact), f32 across groups. Rows k >= K are
// masked (the scales cover a padded last group).
//
// Bound on an H100: at decode (M = batch, a few rows) bytes — the packed
// weight is K N / 2 bytes and is read once, against 2 M K N integer ops
// (llama2-7b's 4096 x 11008 projection: ~23 MB, ~7 us at 3.35 TB/s). At
// prefill (M = batch x prompt) the same weight feeds many rows and the
// integer math grows with M.
//
// Design against that bound: a warp reads whole 128-byte segments of a
// weight row (each lane one 32-bit word: 8 output channels), so weight
// traffic is fully coalesced and each byte is read once per M tile. The
// nibbles of four rows are sign-extended with per-byte SIMD ops, transposed
// with byte permutes and fed to __dp4a against four int8 activations
// staged in shared memory. The four warps of a CTA and, when the N x M
// tiles alone cannot fill the SMs, several CTAs (split-K, a grid z axis)
// take disjoint groups of K; their partial f32 sums meet in shared memory
// and, across CTAs, in a workspace summed by a second small kernel — in a
// fixed order, so results do not change from run to run. Not done yet:
// int8 tensor-core MMA (mma.sync / wgmma) for the prefill shapes, and
// cp.async prefetch of the next weight rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;            // input channels per scale group
constexpr int kTileN = 256;            // output channels per CTA (32 lanes x 8)
constexpr int kBM = 8;                 // activation rows per CTA
static_assert(kBM * 4 == 32, "x staging: four lanes per activation row");

// sign-extend the low nibble of every byte: v ^ 8 - 8, per byte
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return __vsub4((v & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

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

// Grid: (ceil(N / kTileN), ceil(M / kBM), ksplit). Warp w of CTA z owns the
// groups g = z * kWarps + w + i * ksplit * kWarps. With ksplit == 1 the CTA
// writes out = xs * sum; otherwise it writes its partial sum to
// part[z, m, n] for gemv_w4a8_reduce.
__global__ void __launch_bounds__(kThreads)
gemv_w4a8_kernel(const int8_t* __restrict__ xq,       // [M, K]
                 const uint8_t* __restrict__ packed,  // [K, N/2]
                 const float* __restrict__ xs,        // [M]
                 const float* __restrict__ ws,        // [>= ceil(K/128), N]
                 float* __restrict__ out,             // [M, N]
                 float* __restrict__ part,            // [ksplit, M, N] or null
                 int M, int K, int N) {
  __shared__ __align__(16) int8_t x_s[kWarps][kBM][kGroup];
  __shared__ __align__(16) float red_s[kWarps][kBM][kTileN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kTileN + lane * 8;   // this lane's 8 channels
  const int ksplit = gridDim.z;
  const int n_groups = (K + kGroup - 1) / kGroup;
  const int half_n = N / 2;
  const bool lane_live = n0 < N;                   // N % 8 == 0: all 8 or none
  const uint8_t* wcol = packed + n0 / 2;

  float accf[kBM][8];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) accf[m][c] = 0.f;

  for (int g = blockIdx.z * kWarps + warp; g < n_groups; g += ksplit * kWarps) {
    const int k_base = g * kGroup;
    // stage x[m0 : m0 + kBM, k_base : k_base + 128] (zero outside M x K)
    __syncwarp();
    {
      const int m = lane / 4;
      const int kk = (lane % 4) * 32;
      const bool row_ok = m0 + m < M;
      const int8_t* xrow = xq + static_cast<size_t>(m0 + m) * K;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const int k = k_base + kk + i;
        x_s[warp][m][kk + i] = (row_ok && k < K) ? xrow[k] : int8_t(0);
      }
    }
    __syncwarp();

    int acci[kBM][8];
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) acci[m][c] = 0;

    const int rows = min(kGroup, K - k_base);
#pragma unroll 2
    for (int r = 0; r < rows; r += 4) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k_base + r + i;
        w[i] = (lane_live && r + i < rows)
                   ? *reinterpret_cast<const uint32_t*>(wcol + static_cast<size_t>(k) * half_n)
                   : 0u;
      }
      int lo[4], hi[4];   // lo[j]: channel 2j over the 4 rows; hi[j]: 2j + 1
      transpose4(sext_nibbles(w[0]), sext_nibbles(w[1]), sext_nibbles(w[2]),
                 sext_nibbles(w[3]), lo);
      transpose4(sext_nibbles(w[0] >> 4), sext_nibbles(w[1] >> 4), sext_nibbles(w[2] >> 4),
                 sext_nibbles(w[3] >> 4), hi);
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        const int x4 = *reinterpret_cast<const int*>(&x_s[warp][m][r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acci[m][2 * j] = __dp4a(x4, lo[j], acci[m][2 * j]);
          acci[m][2 * j + 1] = __dp4a(x4, hi[j], acci[m][2 * j + 1]);
        }
      }
    }

    if (lane_live) {
      const float4 s0 = *reinterpret_cast<const float4*>(ws + static_cast<size_t>(g) * N + n0);
      const float4 s1 =
          *reinterpret_cast<const float4*>(ws + static_cast<size_t>(g) * N + n0 + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int m = 0; m < kBM; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) accf[m][c] += static_cast<float>(acci[m][c]) * sc[c];
    }
  }

  // sum the four warps' partials through shared memory
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) red_s[warp][m][lane * 8 + c] = accf[m][c];
  __syncthreads();
  for (int e = tid; e < kBM * kTileN; e += kThreads) {
    const int m = e / kTileN;
    const int c = e - m * kTileN;
    const int row = m0 + m;
    const int n = blockIdx.x * kTileN + c;
    if (row < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red_s[w][m][c];
      const size_t idx = static_cast<size_t>(row) * N + n;
      if (part == nullptr)
        out[idx] = s * xs[row];
      else
        part[static_cast<size_t>(blockIdx.z) * M * N + idx] = s;
    }
  }
}

// out[m, n] = xs[m] * sum_z part[z, m, n], z in a fixed order
__global__ void gemv_w4a8_reduce(const float* __restrict__ part, const float* __restrict__ xs,
                                 float* __restrict__ out, int M, int N, int ksplit) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < ksplit; ++z) s += part[z * mn + i];
    out[i] = s * xs[i / N];
  }
}

}  // namespace

// xq: [M, K] int8; packed: [K, N/2] uint8; xs: [M] f32; ws: [ceil(K/128), N]
// f32; out: [M, N] f32; part: [ksplit, M, N] f32 workspace when ksplit > 1,
// else null. N must be a multiple of 8 and packed / ws 16-byte aligned.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int gemv_w4a8_launch(const void* xq, const void* packed, const void* xs,
                                const void* ws, void* out, void* part, int M, int K, int N,
                                int ksplit, void* stream) {
  if (M < 1 || K < 1 || N < 8 || N % 8 != 0 || ksplit < 1 || (ksplit > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kBM - 1) / kBM, ksplit);
  gemv_w4a8_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(xs), static_cast<const float*>(ws), static_cast<float*>(out),
      static_cast<float*>(part), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  const size_t want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  gemv_w4a8_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<const float*>(xs),
                                           static_cast<float*>(out), M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gemv_w4a8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
