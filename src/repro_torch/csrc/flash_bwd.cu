// Flash attention backward: given q (B, Hq, Sq, d), k / v (B, Hkv, Skv, d),
// the forward's out (B, Hq, Sq, d) and its rows' lse (B, Hq, Sq) float32
// (flash_attention.cu, with its lse pointer set), and dout (B, Hq, Sq, d),
// writes dq, dk, dv in the inputs' dtype. Semantics are the forward's (GQA,
// q aligned to the END of the kv sequence, causal, window, softcap, scale; a
// row with no kept key contributes 0).
//
// Replaces no TPU kernel: the reference trains through pure-JAX attention
// (src/repro/models/attention.py) and XLA differentiates it; its Pallas
// flash kernel (src/repro/kernels/flash_attention/kernel.py:_flash_kernel) is
// forward only. This is the gradient that jax.vjp of that attention gives,
// for the port's models, whose attention on the card runs in the flash
// kernel (models/attention.py: flash_route, through FlashAttentionFn).
//
// FlashAttention-2's shape, without atomics, so two calls on the same
// inputs give the same bits (a restarted training run replays its steps):
// (1) flash_bwd_delta: D = rowsum(dout * out) in float32, one warp a row;
// (2) a dK / dV kernel: one block per (64-key tile, KV head, batch row)
//     holds its K and V tiles and walks the group's query heads and, for
//     each, the 64-row q tiles that keep some key of the tile, in a fixed
//     order: S = Q K^T, P = exp(S - lse) (exactly 0 where masked),
//     dP = dO V^T, dS = P (dP - D), through the softcap times (1 - tanh^2),
//     times the scale; dV += P^T dO, dK += dS^T Q, kept in registers;
// (3) a dQ kernel: one block per (64-row q tile, q head, batch row) walks
//     the kept key tiles, recomputes S, P, dP and dS and accumulates
//     dQ += dS K.
// Key and q tiles that the causal mask or the window masks entirely are
// skipped (their terms are exactly 0).
//
// Two routes, by dtype alone (mint_flash_bwd_route): bf16 / f16 take the
// tensor-core kernels of flash_bwd_tc.cu (wgmma tiles, P and dS in
// registers; its header has the design); float32 takes this file's FP32
// FMA kernels (flash_bwd_dkdv_ffma, flash_bwd_dq_ffma), since TF32 would
// not hold float32's tolerance. Both share the pre-pass. Nothing falls back
// from one route to the other.
//
// What bounds it on this card: operations. At granite-moe-1b-a400m's
// training shape (8, 16, 2048, 64), causal, the work is about 10 d flops per
// kept (q, k) pair and head, 2.5x the forward's; the dQ kernel's S / dP
// recomputation adds 4 d. The FP32 FMA route does every product on float32
// tiles in shared memory (the forward's float32 route's layout and thread
// tiling: thread (ty, tx) of 16 x 16 owns rows ty*4..+3 and columns
// tx + 16j), bound by the FP32 FMA units (67 TFLOP/s).
#include <type_traits>

#include "flash.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr int PLD = BKV + 4;  // row stride of the P and dS tiles

template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }

template <typename T, int D>
__global__ void flash_bwd_delta(const BwdArgs a) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.B * a.Hq * a.Sq) return;
  const T* o = static_cast<const T*>(a.out) + row * D;
  const T* g = static_cast<const T*>(a.dout) + row * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(to_f(o[c]), to_f(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// acc[i][j] = sum over d of A[(ty*4+i)*LD + c] * Bm[(tx+16j)*LD + c], in
// index order, four d at a time from float4 reads
template <int D>
__device__ __forceinline__ void rows_dot_cols(const float* A, const float* Bm,
                                              float (&acc)[4][4], int ty, int tx) {
  constexpr int LD = tile_ld<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// P and the scaled dS of a thread's 4 x 4 (q row, key) pairs of the tile at
// (q row i0, key j0), from the raw scores s and dp = dO V^T, into the
// [BQ][PLD] tiles Ps (may be null) and Ss
__device__ __forceinline__ void p_and_ds(const BwdArgs& a, const float (&s)[4][4],
                                         const float (&dp)[4][4], const float* Ls,
                                         const float* Ds, int i0, int j0, int ty, int tx,
                                         float* Ps, float* Ss) {
  const int shift = a.Skv - a.Sq;
  const bool capped = a.softcap > 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i, r = i0 + rr, qpos = r + shift;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = tx + 16 * j, kpos = j0 + cc;
      const bool keep = r < a.Sq && kpos < a.Skv && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
      float x = s[i][j] * a.scale, t = 0.f;
      if (capped) {
        t = tanhf(x / a.softcap);
        x = a.softcap * t;
      }
      const float p = keep ? expf(x - Ls[rr]) : 0.f;
      float ds = p * (dp[i][j] - Ds[rr]);
      if (capped) ds *= 1.f - t * t;
      if (Ps) Ps[rr * PLD + cc] = p;
      Ss[rr * PLD + cc] = ds * a.scale;
    }
  }
}

// lse and D of q rows i0..i0+63 of head row `hrow` (= b * Hq + h), 0 past Sq
__device__ __forceinline__ void stage_row_stats(const BwdArgs& a, long long hrow, int i0,
                                                float* Ls, float* Ds) {
  if (threadIdx.x < BQ) {
    const int r = i0 + threadIdx.x;
    const bool ok = r < a.Sq;
    Ls[threadIdx.x] = ok ? a.lse[hrow * a.Sq + r] : 0.f;
    Ds[threadIdx.x] = ok ? a.delta[hrow * a.Sq + r] : 0.f;
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * 64 * tile_ld<D>() + 2 * BQ * PLD + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_ffma(const BwdArgs a) {
  constexpr int LD = tile_ld<D>(), NO = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;            // [BKV][LD]
  float* Vs = Ks + BKV * LD;   // [BKV][LD]
  float* Qs = Vs + BKV * LD;   // [BQ][LD]
  float* Gs = Qs + BQ * LD;    // dO: [BQ][LD]
  float* Ps = Gs + BQ * LD;    // [BQ][PLD]
  float* Ss = Ps + BQ * PLD;   // [BQ][PLD]
  float* Ls = Ss + BQ * PLD;   // [BQ]
  float* Ds = Ls + BQ;         // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int j0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  stage_tile_f32<T, D, LD, THREADS>(
      static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh + j0 * a.k_ss, a.k_ss,
      a.Skv - j0, Ks);
  stage_tile_f32<T, D, LD, THREADS>(
      static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh + j0 * a.v_ss, a.v_ss,
      a.Skv - j0, Vs);

  // the q rows [i_lo, i_hi) that keep some key of [j0, j1)
  const long long shift = a.Skv - a.Sq, j1 = min(j0 + BKV, a.Skv);
  long long i_lo = 0, i_hi = a.Sq;
  if (a.causal) i_lo = max(i_lo, j0 - shift);                        // qpos >= j0
  if (a.window > 0) i_hi = min(i_hi, j1 - 1 + a.window - shift);     // qpos < j1-1+window

  float dk[4][NO], dv[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long hrow = (long long)b * a.Hq + h;
    const T* qh = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* gh = static_cast<const T*>(a.dout) + hrow * a.Sq * D;
    for (long long i0 = (i_lo / BQ) * BQ; i0 < i_hi; i0 += BQ) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      stage_tile_f32<T, D, LD, THREADS>(qh + i0 * a.q_ss, a.q_ss, a.Sq - (int)i0, Qs);
      stage_tile_f32<T, D, LD, THREADS>(gh + i0 * D, D, a.Sq - (int)i0, Gs);
      stage_row_stats(a, hrow, (int)i0, Ls, Ds);
      __syncthreads();
      float s[4][4], dp[4][4];
      rows_dot_cols<D>(Qs, Ks, s, ty, tx);
      rows_dot_cols<D>(Gs, Vs, dp, ty, tx);
      p_and_ds(a, s, dp, Ls, Ds, (int)i0, j0, ty, tx, Ps, Ss);
      __syncthreads();
      // key rows ty*4+i, columns tx+16j: dV += P^T dO, dK += dS^T Q, q in order
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + qq * PLD + ty * 4);
        const float4 s4 = *reinterpret_cast<const float4*>(Ss + qq * PLD + ty * 4);
        float gv[NO], qv[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          gv[j] = Gs[qq * LD + tx + 16 * j];
          qv[j] = Qs[qq * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = comp(p4, i), si = comp(s4, i);
#pragma unroll
          for (int j = 0; j < NO; ++j) {
            dv[i][j] = fmaf(pi, gv[j], dv[i][j]);
            dk[i][j] = fmaf(si, qv[j], dk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = j0 + ty * 4 + i;
    if (r >= a.Skv) continue;
    T* ok = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh + r * a.dk_ss;
    T* ov = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh + r * a.dv_ss;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      store_as(ok + tx + 16 * j, dk[i][j]);
      store_as(ov + tx + 16 * j, dv[i][j]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * 64 * tile_ld<D>() + BQ * PLD + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_ffma(const BwdArgs a) {
  constexpr int LD = tile_ld<D>(), NO = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ][LD]
  float* Gs = Qs + BQ * LD;    // dO: [BQ][LD]
  float* Ks = Gs + BQ * LD;    // [BKV][LD]
  float* Vs = Ks + BKV * LD;   // [BKV][LD]
  float* Ss = Vs + BKV * LD;   // dS: [BQ][PLD]
  float* Ls = Ss + BQ * PLD;   // [BQ]
  float* Ds = Ls + BQ;         // [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the longest (last) q tiles first, as the forward's routes
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int i0 = (n_qt - 1 - (int)blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const long long hrow = (long long)b * a.Hq + h;
  stage_tile_f32<T, D, LD, THREADS>(
      static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh + i0 * a.q_ss, a.q_ss,
      a.Sq - i0, Qs);
  stage_tile_f32<T, D, LD, THREADS>(static_cast<const T*>(a.dout) + (hrow * a.Sq + i0) * D,
                                    D, a.Sq - i0, Gs);
  stage_row_stats(a, hrow, i0, Ls, Ds);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // the kv range any row of this tile keeps (the forward's cut)
  const int shift = a.Skv - a.Sq;
  const int qlo = i0 + shift, qhi = min(i0 + BQ, a.Sq) - 1 + shift;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, qhi + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, qlo - a.window + 1);

  float dq[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) dq[i][j] = 0.f;

  for (int j0 = (kv_begin / BKV) * BKV; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // the previous tile's K and dS are read
    stage_tile_f32<T, D, LD, THREADS>(kb + j0 * a.k_ss, a.k_ss, a.Skv - j0, Ks);
    stage_tile_f32<T, D, LD, THREADS>(vb + j0 * a.v_ss, a.v_ss, a.Skv - j0, Vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot_cols<D>(Qs, Ks, s, ty, tx);
    rows_dot_cols<D>(Gs, Vs, dp, ty, tx);
    p_and_ds(a, s, dp, Ls, Ds, i0, j0, ty, tx, nullptr, Ss);
    __syncthreads();
    // q rows ty*4+i, columns tx+16j: dQ += dS K over the tile's keys in order
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s4[i] = *reinterpret_cast<const float4*>(Ss + (ty * 4 + i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) kv[j] = Ks[(kk + u) * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float si = comp(s4[i], u);
#pragma unroll
          for (int j = 0; j < NO; ++j) dq[i][j] = fmaf(si, kv[j], dq[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty * 4 + i;
    if (r >= a.Sq) continue;
    T* o = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh + r * a.dq_ss;
#pragma unroll
    for (int j = 0; j < NO; ++j) store_as(o + tx + 16 * j, dq[i][j]);
  }
}

template <typename T, int D>
cudaError_t launch_delta(const BwdArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  flash_bwd_delta<T, D><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS,
                          0, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ffma(const BwdArgs& a, cudaStream_t s) {
  const int kv_bytes = dkdv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_ffma<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_ffma<float, D>
      <<<dim3((a.Skv + BKV - 1) / BKV, a.Hkv, a.B), THREADS, kv_bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int q_bytes = dq_smem_floats<D>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dq_ffma<float, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_ffma<float, D><<<dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B), THREADS, q_bytes, s>>>(a);
  return cudaGetLastError();
}

// the pre-pass, then the route's dK / dV and dQ kernels
template <typename T, int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t s) {
  cudaError_t err = launch_delta<T, D>(a, s);
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, float>::value) return launch_ffma<D>(a, s);
  else return flash_bwd_tensor_core<T>(a, D, s);
}

template <typename T>
cudaError_t flash_bwd(const BwdArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_bwd<T, 32>(a, s);
    case 64: return launch_bwd<T, 64>(a, s);
    case 128: return launch_bwd<T, 128>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The backward's route, by dtype alone: tensor cores for bf16 / f16, FP32
// FMA for float32. -1 for a dtype no route takes.
extern "C" int mint_flash_bwd_route(int dtype) {
  if (dtype == DTYPE_BF16 || dtype == DTYPE_F16) return BWD_ROUTE_TENSOR_CORE;
  return dtype == DTYPE_F32 ? BWD_ROUTE_FFMA : -1;
}

// Strides are in elements, for the (batch, head, sequence) axes of q, k, v
// and of the gradients dq, dk, dv (each laid out like its input or
// contiguous); the head axis of each is contiguous. q, k, v, out and dout
// start on 16 bytes with strides of whole 16-byte vectors (the wrapper
// checks); out and dout are contiguous (B, Hq, Sq, d). delta is (B, Hq, Sq)
// float32 scratch.
extern "C" int mint_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int Hq, int Hkv,
    int Sq, int Skv, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float softcap, float scale, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Sq <= 0 || Skv <= 0) return cudaErrorInvalidValue;
  const BwdArgs a = {q,     k,     v,     out,   dout,  (const float*)lse,
                     dq,    dk,    dv,    (float*)delta,
                     B,     Hq,    Hkv,   Sq,    Skv,
                     q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,
                     dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
                     causal, window, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mint_flash_bwd_route(dtype)) {
    case BWD_ROUTE_TENSOR_CORE:
      if (dtype == DTYPE_BF16) return flash_bwd<__nv_bfloat16>(a, d, s);
      return flash_bwd<__half>(a, d, s);
    case BWD_ROUTE_FFMA:
      return flash_bwd<float>(a, d, s);
  }
  return cudaErrorInvalidValue;
}
