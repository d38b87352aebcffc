// Shared pieces of the flash-attention routes (flash_attention.cu: the
// route choice, the entry point and the float32 route; flash_split.cu: the
// split-KV decode route; flash_tc.cu: the tensor-core prefill route).
#pragma once

#include "select.cuh"

// Route codes; mint_flash_route (flash_attention.cu) is the one rule.
enum { ROUTE_SPLIT_KV = 0, ROUTE_TENSOR_CORE = 1, ROUTE_FP32 = 2 };

// Rows of q (Sq x the GQA group) up to which the split-KV route serves a call.
#define MINT_SPLIT_ROWS 64

// One call's operands. Strides are in elements for the (batch, head,
// sequence) axes; the head dim is contiguous. out is (B, Hq, Sq, d),
// contiguous. A kv position is kept if it is < Skv, <= the q position under
// `causal` and > the q position - window when window > 0; q row i sits at
// position Skv - Sq + i.
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
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

template <typename T>
cudaError_t flash_split_kv(const FlashArgs& a, int d, const SplitPlan& plan,
                           cudaStream_t s);
template <typename T>
cudaError_t flash_tensor_core(const FlashArgs& a, int d, cudaStream_t s);
