// Flash attention, route (a): split-KV decode, for calls whose q rows of
// one KV head (Sq x the GQA group) fit one tile of 64 rows. Every decode
// step takes it. Semantics as in flash_attention.cu.
//
// What bounds it: bytes. A decode step reads each kept K / V row once (at
// Gemma-2-27B's global layer 2 x 16 heads x 8,193 keys x 128 x 2 bytes x 2,
// 134 MB) and does 4 flops per (q row, key, d), far under the card's ridge.
// So the design is about reading K / V once, from every SM at once:
// - one block per (KV split, KV head, batch row) holds all `group` query
//   heads x Sq rows of its KV head, so a GQA group reads its K / V once,
//   not once per query head;
// - the kept kv range (after the causal and window cut) is cut into
//   n_splits runs (kernels/flash_attention/kernel.py: split_plan) so the
//   grid has at least two blocks per SM;
// - each of a block's 4 warps walks every 4th chunk of 8 keys of the split
//   on its own: the chunk's K / V rows come by 16-byte cp.async into the
//   warp's two stages (the next chunk's copy overlaps this chunk's work,
//   with warp barriers only), a key's d axis is spread over the lanes (so a
//   q.k is a few FMAs and a shuffle reduction), and the warp keeps its own
//   online softmax for up to 8 q rows in registers (more rows take more
//   passes); the products are FP32 FMA (bytes, not operations, bound the
//   route);
// - the block folds its warps' (m, l, acc) in warp order into the split's;
// - each split writes its (m, l, acc) in f32 to scratch the wrapper
//   allocates, and combine_kernel folds the splits in split order, so the
//   result does not depend on block scheduling.
#include "cp_async.cuh"
#include "flash.cuh"

namespace {

constexpr int WARPS = 4, THREADS = WARPS * 32;
constexpr int KC = 8;      // keys a warp stages and scores at a time
constexpr int NSTAGE = 3;  // chunks a warp has in shared memory (two in flight)

template <typename T, int D>
struct SplitLayout {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte piece
  static constexpr int CPR = D / VEC;              // lanes that share one key
  static constexpr int KPS = 32 / CPR;             // keys a warp takes per step
  static constexpr int STEPS = KC / KPS;
  static constexpr int STAGE = KC * D;             // elements of one K or V stage
  static_assert(CPR <= 32 && KC % KPS == 0, "split layout");
};

// Block (split, KV head, batch row); each warp walks every 4th chunk of KC
// keys of the split with its own online softmax over RR q rows at a time,
// then the block folds its 4 warps in order and writes the split's partial.
// RR = 2 (a GQA pair at decode) keeps the registers low enough for four
// blocks an SM; RR = 8 serves up to 64 rows in passes of 8.
template <typename T, int D, int RR>
__global__ void __launch_bounds__(THREADS, RR <= 2 ? 4 : 2)
split_kernel(const FlashArgs a, const SplitPlan pl) {
  using L = SplitLayout<T, D>;
  constexpr int VEC = L::VEC, CPR = L::CPR, KPS = L::KPS, STEPS = L::STEPS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // per warp: [stage][K, V][KC][D]
  T* kvs = reinterpret_cast<T*>(smem) + warp * NSTAGE * 2 * L::STAGE;
  float* Ws = reinterpret_cast<float*>(smem + WARPS * NSTAGE * 2 * L::STAGE * sizeof(T));  // [warp][RR][D]
  float* Ms = Ws + WARPS * RR * D;  // [warp][RR]
  float* Ls = Ms + WARPS * RR;      // [warp][RR]

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv, R = group * a.Sq;
  const int s0 = pl.kv_begin + split * pl.chunk;
  const int s1 = min(s0 + pl.chunk, pl.kv_end);
  const int nchunks = s1 > s0 ? (s1 - s0 + KC - 1) / KC : 0;
  const int mine = nchunks > warp ? (nchunks - warp + WARPS - 1) / WARPS : 0;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int kg = lane / CPR, sl = lane % CPR;  // this lane's key in a step, its d slice
  const T* tag = nullptr;
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;

  // chunk `it` of this warp into stage st: KC rows of K and of V, zero past s1
  auto load = [&](int it, int st) {
    const int j0 = s0 + (warp + it * WARPS) * KC;
    T* ks = kvs + st * 2 * L::STAGE;
    T* vs = ks + L::STAGE;
    for (int e = lane; e < KC * CPR; e += 32) {
      const int r = e / CPR, c = (e % CPR) * VEC;
      const bool ok = j0 + r < s1;
      const long long row = ok ? j0 + r : 0;
      cp_async<16>(ks + r * D + c, kb + row * a.k_ss + c, ok);
      cp_async<16>(vs + r * D + c, vb + row * a.v_ss + c, ok);
    }
  };

  const size_t base = ((size_t)(b * a.Hkv + hk) * pl.n_splits + split) * R;
  for (int r0 = 0; r0 < R; r0 += RR) {
    float q[RR][VEC], acc[RR][VEC], m[RR], l[RR];
    int qpos[RR];
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
      const int r = min(r0 + rr, R - 1);
      const int g = r / a.Sq, i = r % a.Sq;
      qpos[rr] = a.Skv - a.Sq + i;
      const T* src = static_cast<const T*>(a.q) + b * a.q_sb +
                     (long long)(hk * group + g) * a.q_sh + i * a.q_ss + sl * VEC;
      unpack(__ldg(reinterpret_cast<const uint4*>(src)), q[rr], tag);
      m[rr] = MINT_NEG_INF;
      l[rr] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[rr][e] = 0.f;
    }

#pragma unroll
    for (int it = 0; it < NSTAGE - 1; ++it) {
      if (it < mine) load(it, it);
      cp_async_commit();
    }
    for (int it = 0; it < mine; ++it) {
      if (it + NSTAGE - 1 < mine) load(it + NSTAGE - 1, (it + NSTAGE - 1) % NSTAGE);
      cp_async_commit();
      cp_async_wait<NSTAGE - 1>();
      __syncwarp();
      const T* ks = kvs + (it % NSTAGE) * 2 * L::STAGE;
      const T* vs = ks + L::STAGE;
      const int j0 = s0 + (warp + it * WARPS) * KC;

      // scores of this lane's keys (one per step) for each row
      float sc[RR][STEPS];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float kf[VEC];
        unpack(*reinterpret_cast<const uint4*>(ks + (st * KPS + kg) * D + sl * VEC), kf, tag);
        const int kpos = j0 + st * KPS + kg;
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
          if (r0 + rr >= R) break;  // uniform: rows past R are not computed
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x = fmaf(q[rr][e], kf[e], x);
#pragma unroll
          for (int off = 1; off < CPR; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
          x *= a.scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x * inv_cap);
          const bool keep = kpos < s1 && (!a.causal || kpos <= qpos[rr]) &&
                            (a.window <= 0 || kpos > qpos[rr] - a.window);
          sc[rr][st] = keep ? x : MINT_NEG_INF;
        }
      }
      // one online-softmax step per row for the chunk
#pragma unroll
      for (int rr = 0; rr < RR; ++rr) {
        if (r0 + rr >= R) break;
        float mx = sc[rr][0];
#pragma unroll
        for (int st = 1; st < STEPS; ++st) mx = fmaxf(mx, sc[rr][st]);
#pragma unroll
        for (int off = CPR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[rr], mx);
        const float alpha = expf(m[rr] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          sc[rr][st] = sc[rr][st] == MINT_NEG_INF ? 0.f : expf(sc[rr][st] - m_new);
          ps += sc[rr][st];
        }
        l[rr] = l[rr] * alpha + ps;  // this lane's keys; summed over key groups at the end
        m[rr] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[rr][e] *= alpha;
      }
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        float vf[VEC];
        unpack(*reinterpret_cast<const uint4*>(vs + (st * KPS + kg) * D + sl * VEC), vf, tag);
#pragma unroll
        for (int rr = 0; rr < RR; ++rr) {
          if (r0 + rr >= R) break;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[rr][e] = fmaf(sc[rr][st], vf[e], acc[rr][e]);
        }
      }
      __syncwarp();  // the stage is read before it is loaded again
    }

    // sum over this warp's key groups, then fold the warps in order
#pragma unroll
    for (int rr = 0; rr < RR; ++rr) {
#pragma unroll
      for (int off = CPR; off < 32; off <<= 1) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], off);
      }
      if (kg == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) Ws[(warp * RR + rr) * D + sl * VEC + e] = acc[rr][e];
      }
      if (lane == 0) {
        Ms[warp * RR + rr] = m[rr];
        Ls[warp * RR + rr] = l[rr];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RR * D; e += THREADS) {
      const int rr = e / D, c = e % D, r = r0 + rr;
      if (r >= R) continue;
      float M = MINT_NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Ms[w * RR + rr]);
      float lo = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float sw = expf(Ms[w * RR + rr] - M);
        lo += Ls[w * RR + rr] * sw;
        o += Ws[(w * RR + rr) * D + c] * sw;
      }
      pl.part_acc[(base + r) * D + c] = o;
      if (c == 0) {
        pl.part_m[base + r] = M;
        pl.part_l[base + r] = lo;
      }
    }
    __syncthreads();
  }
}

// out[b, h, i, c] from the splits' partials, folded in split order
template <typename T>
__global__ void combine_kernel(const FlashArgs a, const SplitPlan pl, int d) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (size_t)a.B * a.Hq * a.Sq * d) return;
  const int c = (int)(tid % d);
  const size_t row = tid / d;
  const int i = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.Hq);
  const int b = (int)(row / ((size_t)a.Sq * a.Hq));
  const int group = a.Hq / a.Hkv, R = group * a.Sq;
  const int r = (h % group) * a.Sq + i;
  const size_t base = (size_t)(b * a.Hkv + h / group) * pl.n_splits * R + r;
  float M = MINT_NEG_INF;
  for (int s = 0; s < pl.n_splits; ++s) M = fmaxf(M, pl.part_m[base + (size_t)s * R]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < pl.n_splits; ++s) {
    const size_t at = base + (size_t)s * R;
    const float w = expf(pl.part_m[at] - M);
    L += pl.part_l[at] * w;
    O += pl.part_acc[at * d + c] * w;
  }
  store_as(static_cast<T*>(a.out) + tid, O / fmaxf(L, 1e-30f));
}

template <typename T, int D, int RR>
cudaError_t launch_rows(const FlashArgs& a, const SplitPlan& pl, cudaStream_t s) {
  using L = SplitLayout<T, D>;
  const size_t smem = (size_t)WARPS * NSTAGE * 2 * L::STAGE * sizeof(T) +
                      (size_t)WARPS * RR * (D + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, D, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  split_kernel<T, D, RR><<<dim3(pl.n_splits, a.Hkv, a.B), THREADS, smem, s>>>(a, pl);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split(const FlashArgs& a, const SplitPlan& pl, cudaStream_t s) {
  const int R = (a.Hq / a.Hkv) * a.Sq;
  if (R > MINT_SPLIT_ROWS) return cudaErrorInvalidValue;
  cudaError_t err = R <= 2 ? launch_rows<T, D, 2>(a, pl, s) : launch_rows<T, D, 8>(a, pl, s);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)a.B * a.Hq * a.Sq * D;
  combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a, pl, D);
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t flash_split_kv(const FlashArgs& a, int d, const SplitPlan& plan,
                           cudaStream_t s) {
  switch (d) {
    case 32: return launch_split<T, 32>(a, plan, s);
    case 64: return launch_split<T, 64>(a, plan, s);
    case 128: return launch_split<T, 128>(a, plan, s);
  }
  return cudaErrorInvalidValue;
}

template cudaError_t flash_split_kv<float>(const FlashArgs&, int, const SplitPlan&,
                                           cudaStream_t);
template cudaError_t flash_split_kv<__nv_bfloat16>(const FlashArgs&, int,
                                                   const SplitPlan&, cudaStream_t);
template cudaError_t flash_split_kv<__half>(const FlashArgs&, int, const SplitPlan&,
                                            cudaStream_t);
