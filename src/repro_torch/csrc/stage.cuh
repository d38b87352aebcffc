// Row staging shared by the streaming scan and the distance kernel: a piece
// of each of a tile's rows copied global -> shared by cp.async, and the
// exact f32 value of one element of 16 loaded bytes of a row.
//
// Both kernels read the same rows through these two functions and sum
// fmaf(q, x, acc) over d in index order from 0, so their scores are
// bit-identical (the contract of csrc/streaming.cu and csrc/distance.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "cp_async.cuh"

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}
// element v of 16 loaded bytes of T, as float32 (exact)
__device__ __forceinline__ float lane_val(const uint4& r, int v, const float*) {
  return __uint_as_float(word(r, v));
}
__device__ __forceinline__ float lane_val(const uint4& r, int v, const __nv_bfloat16*) {
  const uint32_t w = word(r, v >> 1);
  return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float lane_val(const uint4& r, int v, const __half*) {
  const uint32_t w = word(r, v >> 1);
  return __half2float(__ushort_as_half((unsigned short)((v & 1) ? (w >> 16) : (w & 0xffffu))));
}

// ROW_BYTES bytes (from byte cb0 of each row) of rows r0 .. r0+NROWS-1 into
// dst at a stride of ROW_BYTES + 16 bytes (conflict-free 16-byte reads of
// neighbouring rows), zero past row `rend` or the row's end; VB-byte pieces
// (cp.async, or plain 2-byte copies when the rows are only 2-byte aligned)
template <int VB, int THREADS, int ROW_BYTES, int NROWS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const char* rows,
                                           size_t rbytes, int r0, int rend, size_t cb0) {
  constexpr int PER_ROW = ROW_BYTES / VB, RSTRIDE = ROW_BYTES + 16;
  for (int e = threadIdx.x; e < NROWS * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * VB;
    const size_t cb = cb0 + c;
    const bool ok = r0 + r < rend && cb < rbytes;
    const char* g = ok ? rows + (size_t)(r0 + r) * rbytes + cb : rows;
    if constexpr (VB == 2) {
      *reinterpret_cast<unsigned short*>(dst + r * RSTRIDE + c) =
          ok ? *reinterpret_cast<const unsigned short*>(g) : (unsigned short)0;
    } else {
      cp_async<VB>(dst + r * RSTRIDE + c, g, ok);
    }
  }
}

// stage_rows at the byte width the wrapper found every row to start on
template <int THREADS, int ROW_BYTES, int NROWS>
__device__ __forceinline__ void stage_rows_vb(int vb, unsigned char* dst, const char* rows,
                                              size_t rbytes, int r0, int rend, size_t cb0) {
  switch (vb) {
    case 16: stage_rows<16, THREADS, ROW_BYTES, NROWS>(dst, rows, rbytes, r0, rend, cb0); break;
    case 8: stage_rows<8, THREADS, ROW_BYTES, NROWS>(dst, rows, rbytes, r0, rend, cb0); break;
    case 4: stage_rows<4, THREADS, ROW_BYTES, NROWS>(dst, rows, rbytes, r0, rend, cb0); break;
    default: stage_rows<2, THREADS, ROW_BYTES, NROWS>(dst, rows, rbytes, r0, rend, cb0); break;
  }
}
