// Shared pieces of the flash-attention routes (flash_attention.cu: the
// route choice, the entry point and the float32 route; flash_split.cu: the
// split-KV decode route; flash_tc.cu: the tensor-core prefill route) and of
// the backward's (flash_bwd.cu: the route choice, the entry point, the
// pre-pass and the FP32 FMA route; flash_bwd_tc.cu: the tensor-core route).
#pragma once

#include "select.cuh"

// Route codes; mint_flash_route (flash_attention.cu) is the one rule.
enum { ROUTE_SPLIT_KV = 0, ROUTE_TENSOR_CORE = 1, ROUTE_FP32 = 2 };

// Backward route codes; mint_flash_bwd_route (flash_bwd.cu) is the one rule.
enum { BWD_ROUTE_TENSOR_CORE = 0, BWD_ROUTE_FFMA = 1 };

// Rows of q (Sq x the GQA group) up to which the split-KV route serves a call.
#define MINT_SPLIT_ROWS 64

// One call's operands. Strides are in elements for the (batch, head,
// sequence) axes; the head dim is contiguous. out is (B, Hq, Sq, d),
// contiguous. A kv position is kept if it is < Skv, <= the q position under
// `causal` and > the q position - window when window > 0; q row i sits at
// position Skv - Sq + i. lse, when not null, is (B, Hq, Sq) float32: each
// row's natural-log sum of exp over its kept scores (what the backward,
// flash_bwd.cu, recomputes P from), MINT_NEG_INF for a row with none.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int causal, window;
  float softcap, scale;
  float* lse;
};

// A row's lse from its running max m (in the units of `ln_unit`: 1 for
// natural-log scores, ln 2 for log2 ones) and its sum l of exp(s - m).
__device__ __forceinline__ float row_lse(float m, float l, float ln_unit) {
  return m == MINT_NEG_INF ? MINT_NEG_INF : m * ln_unit + logf(fmaxf(l, 1e-30f));
}

// One backward call's operands. q, k, v and the gradients dq, dk, dv have
// strides in elements for the (batch, head, sequence) axes, the head dim
// contiguous; out and dout are contiguous (B, Hq, Sq, d); lse is the
// forward's (FlashArgs::lse) and delta the pre-pass's rowsum(dout * out),
// both (B, Hq, Sq) float32. Semantics (masks, q alignment) are FlashArgs'.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* delta;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int causal, window;
  float softcap, scale;
};

// The split-KV plan of kernels/flash_attention/kernel.py:split_plan: the
// kept kv range [kv_begin, kv_end) cut into n_splits runs of `chunk` keys,
// and the f32 scratch for each split's (m, l, acc).
struct SplitPlan {
  int kv_begin, kv_end, chunk, n_splits;
  float* part_m;    // (B, Hkv, n_splits, rows)
  float* part_l;    // (B, Hkv, n_splits, rows)
  float* part_acc;  // (B, Hkv, n_splits, rows, d)
};

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_as(__half* p, float x) { *p = __float2half(x); }

// The float32 values of 16 loaded bytes of T (the pointer only picks the type).
__device__ __forceinline__ void unpack(uint4 r, float* f, const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 r, float* f, const __half*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

// Rows 0..63 of a (rows, D) operand (the float32 route's and the backward's
// tiles; THREADS threads share the copy) whose row r starts at src + r * stride,
// zero from row `valid` on, into dst[r * LD + c] as float32. Each thread
// first issues all of its 16-byte loads, then converts and stores, so a
// tile pays the load latency once.
template <typename T, int D, int LD, int THREADS>
__device__ __forceinline__ void stage_tile_f32(const T* __restrict__ src, long long stride,
                                               int valid, float* __restrict__ dst) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = D / VEC;
  constexpr int PER = 64 * CHUNKS / THREADS;
  static_assert(PER * THREADS == 64 * CHUNKS && VEC % 4 == 0, "tile split");
  uint4 raw[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / CHUNKS, c = (e % CHUNKS) * VEC;
    raw[u] = r < valid ? __ldg(reinterpret_cast<const uint4*>(src + r * stride + c))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / CHUNKS, c = (e % CHUNKS) * VEC;
    float f[VEC];
    unpack(raw[u], f, static_cast<const T*>(nullptr));
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

template <typename T>
cudaError_t flash_split_kv(const FlashArgs& a, int d, const SplitPlan& plan,
                           cudaStream_t s);
template <typename T>
cudaError_t flash_tensor_core(const FlashArgs& a, int d, cudaStream_t s);
// the backward's dK / dV and dQ kernels on the tensor-core route (after the
// pre-pass has written delta)
template <typename T>
cudaError_t flash_bwd_tensor_core(const BwdArgs& a, int d, cudaStream_t s);
