// Flash attention forward: q (B, Hq, Sq, d), k / v (B, Hkv, Skv, d) ->
// out (B, Hq, Sq, d) in q's dtype, with online softmax in float32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:_flash_kernel (grid
// (B, Hq, Sq/bq, Skv/bkv) with the KV axis walked in order, the running
// (m, l, acc) kept in VMEM scratch across grid steps). Semantics kept by
// every route: query head h reads KV head h / (Hq / Hkv); q row i sits at
// position Skv - Sq + i (aligned to the END of the kv sequence); a kv
// position is kept if it is < Skv, <= the q position under `causal`, and
// > the q position - window when window > 0; scores are q.k * scale, then
// cap * tanh(s / cap) when cap > 0, then masked to NEG_INF, and masked
// terms add exactly 0. A row with no kept position gives 0 (l clamped at
// 1e-30). On the model path window is 4096 (Gemma-2 local layers) or
// 1 << 30 (global layers: no mask, passed as an int32).
//
// Three routes, chosen by shape and dtype in mint_flash_route (never by a
// failure):
// (a) split-KV decode (flash_split.cu) when Sq x group <= 64 rows: every
//     decode step. One block per (batch row, KV head, KV split) holds all
//     the group's query heads, so K / V are read once per KV head, and the
//     kept range is cut into enough splits to fill the card; a combine
//     kernel folds the splits' (m, l, acc) in split order. Bound: bytes.
// (b) tensor-core prefill (flash_tc.cu) for bf16 / f16 beyond that:
//     mma.sync m16n8k16 products with f32 accumulation, K / V tiles by
//     cp.async. Bound: operations.
// (c) float32 beyond that: this file's FP32-FMA kernel, below, unchanged
//     from the first port (f32 products; TF32 would not hold the f32
//     tolerance).
//
// Route (c). Blocks run in no order, so the sequential KV grid axis becomes
// a loop inside the block: one block per (64-query tile, q head, batch row)
// stages its q tile in shared memory once, then walks 64-row K/V tiles.
// Tiles are staged as float32 from 16-byte loads, each thread issuing all
// of its loads before its stores, so a tile pays the load latency once.
// 256 threads; thread (ty, tx) owns query rows ty*4 .. ty*4+3, score
// columns tx + 16j and output columns tx + 16j, so the row max and row sum
// are shuffles inside a half-warp and (m, l, acc) stay in registers for
// the whole walk. Q.K^T and P.V are FP32 FMA in index order (Q.K^T from
// float4 shared reads: 8 loads per 64 FMAs), exp is expf. The P tile takes
// the K tile's shared memory once the scores are taken: 100,352 bytes at
// d = 128, so two blocks fit on an SM. K/V tiles that the causal mask or
// the window masks entirely are skipped: exact, since on such a tile
// m_cur = NEG_INF gives alpha = 1 and p = 0. It is bound by the FP32 FMA
// units (67 TFLOP/s) and its scalar shared reads of V.
#include "flash.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr int PLD = BKV + 4;  // row stride of the P tile in shared memory

// shared-memory row stride of the q and k tiles: a multiple of 4 floats
// (16-byte rows for float4 reads) whose bank offset of 4 per row keeps the
// reads of 8 neighbouring rows conflict-free
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 4; }

template <int D>
__host__ __device__ constexpr int smem_floats() {
  // q tile, then the k tile (which the p tile reuses once the scores are
  // taken), then the v tile
  constexpr int kp = BKV * tile_ld<D>() > BQ * PLD ? BKV * tile_ld<D>() : BQ * PLD;
  return BQ * tile_ld<D>() + kp + BKV * D;
}

// Rows 0..63 of a (rows, D) operand whose row r starts at src + r * stride,
// zero from row `valid` on, into dst[r * LD + c] as float32. Each thread
// first issues all of its 16-byte loads, then converts and stores, so a
// tile pays the load latency once.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long stride,
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Hq, int group,
                 int Sq, int Skv, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                 long long v_sh, long long v_ss, int causal, int window,
                 float softcap, float scale) {
  constexpr int LD = tile_ld<D>();
  constexpr int NO = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* Ks = Qs + BQ * LD;      // [BKV][LD], then P: [BQ][PLD]
  float* Ps = Ks;
  float* Vs = Ks + (smem_floats<D>() - BQ * LD - BKV * D);  // [BKV][D]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  stage_rows<T, D, LD>(q + b * q_sb + h * q_sh + q0 * q_ss, q_ss, Sq - q0, Qs);

  // positions of this tile's rows and the kv range any of them can keep
  const int shift = Skv - Sq;
  const int qpos_lo = q0 + shift;
  const int qpos_hi = min(q0 + BQ, Sq) - 1 + shift;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, qpos_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, qpos_lo - window + 1);

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MINT_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  for (int j0 = (kv_begin / BKV) * BKV; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // the previous tile's P and V are no longer read
    stage_rows<T, D, LD>(kb + j0 * k_ss, k_ss, Skv - j0, Ks);
    stage_rows<T, D, D>(vb + j0 * v_ss, v_ss, Skv - j0, Vs);
    __syncthreads();

    // s = q . k over d in index order, four d at a time from float4 reads
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }
    __syncthreads();  // K is read; its space takes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qpos_lo + ty * 4 + i;
      bool keep[4];
      float m_cur = MINT_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = j0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        keep[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                  (window <= 0 || kpos > qpos - window);
        s[i][j] = keep[j] ? x : MINT_NEG_INF;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_new);
      float l_cur = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PLD + tx + 16 * j] = p;
        l_cur += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l_cur += __shfl_xor_sync(0xffffffffu, l_cur, off);
      l[i] = l[i] * alpha + l_cur;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p . v over the tile's keys in index order
#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) vv[j] = Vs[(kk + u) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < NO; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * Hq + h) * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) store_as(o + tx + 16 * j, acc[i][j] / li);
  }
}

template <typename T, int D>
cudaError_t launch_fp32(const FlashArgs& a, cudaStream_t s) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fp32_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flash_fp32_kernel<T, D><<<grid, THREADS, bytes, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out, a.Hq, a.Hq / a.Hkv, a.Sq,
      a.Skv, a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss, a.v_sb, a.v_sh, a.v_ss,
      a.causal, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

cudaError_t flash_fp32(const FlashArgs& a, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch_fp32<float, 32>(a, s);
    case 64: return launch_fp32<float, 64>(a, s);
    case 128: return launch_fp32<float, 128>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The route of a call, by shape and dtype: split-KV when the q rows of one
// KV head (Sq x group) fit one block's tile, else tensor cores for bf16 /
// f16, else the float32 kernel. -1 for a dtype no route takes.
extern "C" int mint_flash_route(int Sq, int group, int dtype) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16 && dtype != DTYPE_F16) return -1;
  if ((long long)Sq * group <= MINT_SPLIT_ROWS) return ROUTE_SPLIT_KV;
  return dtype == DTYPE_F32 ? ROUTE_FP32 : ROUTE_TENSOR_CORE;
}

// Strides are in elements, for the (batch, head, sequence) axes of q, k and
// v; the head axis of each is contiguous (stride 1). Every pointer is 16-byte
// aligned and every stride a multiple of 16 bytes (the wrapper checks).
// out is contiguous. The split plan (kv_begin, kv_end, chunk, n_splits) and
// its f32 scratch are read on the split-KV route only.
extern "C" int mint_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
    int Sq, int Skv, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int causal, int window, float softcap, float scale, int dtype,
    int kv_begin, int kv_end, int chunk, int n_splits, void* part_m, void* part_l,
    void* part_acc, void* stream) {
  const FlashArgs a = {q, k, v, out, B, Hq, Hkv, Sq, Skv, q_sb, q_sh, q_ss, k_sb, k_sh,
                       k_ss, v_sb, v_sh, v_ss, causal, window, softcap, scale};
  const SplitPlan plan = {kv_begin, kv_end, chunk, n_splits, (float*)part_m,
                          (float*)part_l, (float*)part_acc};
  cudaStream_t s = (cudaStream_t)stream;
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  switch (mint_flash_route(Sq, Hq / Hkv, dtype)) {
    case ROUTE_SPLIT_KV:
      if (n_splits < 1 || !part_m || !part_l || !part_acc) return cudaErrorInvalidValue;
      if (dtype == DTYPE_F32) return flash_split_kv<float>(a, d, plan, s);
      if (dtype == DTYPE_BF16) return flash_split_kv<__nv_bfloat16>(a, d, plan, s);
      return flash_split_kv<__half>(a, d, plan, s);
    case ROUTE_TENSOR_CORE:
      if (dtype == DTYPE_BF16) return flash_tensor_core<__nv_bfloat16>(a, d, s);
      return flash_tensor_core<__half>(a, d, s);
    case ROUTE_FP32:
      return flash_fp32(a, d, s);
  }
  return cudaErrorInvalidValue;
}
