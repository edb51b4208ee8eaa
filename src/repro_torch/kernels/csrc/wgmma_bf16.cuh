// bf16 products on Hopper's tensor cores by wgmma, for the bf16 instance of
// B5 (flash_attention.cu). A product of two bf16 values is exact in f32,
// and wgmma sums them in its f32 accumulator, so one bf16 pass is as
// accurate as an f32 product of the same (bf16) operands.
//
// Operands: A from registers, per warp its 16 rows in the mma.m16n8k16 A
// layout (g = lane / 4, c = lane % 4; each register two bf16, the lower
// column in the low half): a0 (g, 2c), a1 (g + 8, 2c), a2 (g, 2c + 8),
// a3 (g + 8, 2c + 8). B from shared memory in the no-swizzle core-matrix
// layout: 8 x 16-byte core matrices (8 rows, 8 bf16 a row, 128 contiguous
// bytes). K-major B (`_k`): a core matrix's rows run along N and its 8
// values along K. MN-major B (`_mn`, the transpose bit set): its rows run
// along K and its 8 values along N, so a tile stored with its rows along K
// (keys) and N contiguous (d) is read as it is. Either way the descriptor
// (meili::core_desc) takes the byte stride between core matrices along K
// and along N. The accumulator holds, per warp, its 16 rows in the m16n8
// layout, n-tile by n-tile: d[j][e] is row g + 8 (e / 2), column
// 8j + 2c + e % 2.
#pragma once

#include "tf32x3.cuh"

namespace meili {

// Two floats as registers of bf16 A values (x the lower column), each
// split as v = hi + lo + e with hi = bf16(v), lo = bf16(v - hi) (rounded
// to nearest even) and |e| <= 2^-9 |lo| <= 2^-18 |v|: two bf16 operands
// carry 16 bits of v.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D (64 x 32, f32) += A (64 x 16, K-major) · B (16 x 32, K-major), both
// from shared memory.
__device__ __forceinline__ void wgmma_bf16_n32_ss(float (&d)[4][4],
                                                  uint64_t adesc,
                                                  uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(adesc), "l"(bdesc));
}

// D (64 x 128, f32) += A (64 x 16) · B (16 x 128, MN-major).
__device__ __forceinline__ void wgmma_bf16_n128_mn(float (&d)[16][4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

}  // namespace meili
