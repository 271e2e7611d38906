// Fused gate -> matrix product for NVIDIA Hopper (sm_90a), bfloat16 on the
// tensor cores ("route A"), plain C interface.  Built with the other sources
// by repro_torch/kernels/build.py; launched through masked_act_matmul_launch
// (masked_act_matmul.cu), which hands it every bfloat16 call whose K and
// N_out are multiples of 8 and whose operands are 16-byte aligned.  The
// float32 kernel and every other shape take route B (masked_act_matmul.cu).
//
//  * gate_matmul_wgmma_kernel <- src/repro/kernels/masked_act.py
//                                masked_act_matmul_2d (:235) and
//                                masked_act_matmul_2d_batched (:299)
//    out = ((m*act(x) + (1-m)*x) [* mul]) @ w in bfloat16, float32 sums.
//
//    Bound by operations: 2*rows*K*Nout flops at 989 TFLOP/s against
//    (2*rows*K + K*Nout + rows*Nout) * 2 bytes at 3.35 TB/s, about 720 flops
//    a byte at the LM's shapes, above the tensor cores' ridge (295).  What
//    the tensor cores cannot do is the gate: every A element is gated on the
//    CUDA cores (silu: an exp and a reciprocal, ~24 instructions) before it
//    is multiplied, once per block, so a block's gate work per k step is
//    fixed by its rows and its products by its width.  The design therefore
//    takes the widest output tile whose accumulators fit (128 x 256) and
//    runs the gate beside the products (on an H100 the silu gate still does
//    not hide behind them: each element is gated once per 256 columns;
//    PERF.md):
//      - a producer warp keeps TMA loads in flight into a 3-stage ring of
//        shared-memory tiles with full/empty mbarriers (its warpgroup
//        hands its registers to the consumers with setmaxnreg): x and mul
//        (128 rows x 64 k, 128-byte swizzle), w (64 k x 256 n, four 64 x 64
//        boxes taken N-major as w lies in (K, N_out) row-major; wgmma's
//        transpose bit for B) and the candidate's mask slice (64 floats);
//      - two consumer warpgroups own 64 rows x 256 columns each.  For each
//        16-k step a thread ldmatrix-es its A fragment of x (and mul) out of
//        the swizzled tile, gates it in float32, rounds it to bfloat16,
//        multiplies by mul and rounds again (where the reference and the
//        unfused route round), packs it and issues
//        wgmma.m64n256k16.f32.bf16.bf16 with A from registers and B by
//        descriptor; one wgmma stays in flight while the next fragment is
//        gated, and a stage goes back to the producer when the last wgmma
//        that read it has completed;
//      - the epilogue rounds the float32 accumulators once, with predicated
//        stores for the ragged rows and N_out.
//    Candidates are blockIdx.z: the row coordinate is offset by cand*rows
//    only when the candidate stride is not 0, so one tensor map serves a
//    stacked and an expand-ed (shared) x.  Ragged rows and K are TMA's zero
//    fill (every kind gates 0 to 0 under any mask).  Rows past a candidate's
//    last row may read the next candidate's rows; they feed only output
//    rows that are never stored.

#include "masked_act_common.cuh"
#include "masked_act_sm90.cuh"

namespace {

constexpr int WG_BM = 128;               // rows per block (two warpgroups)
constexpr int WG_BN = 256;               // output columns per block
constexpr int WG_BK = 64;                // k per stage (128 bytes of bf16)
constexpr int WG_STAGES = 3;
constexpr int WG_CONSUMERS = 256;
constexpr int WG_THREADS = WG_CONSUMERS + 128;  // + the producer warpgroup
constexpr int X_TILE = WG_BM * WG_BK * 2;       // 16 KB
constexpr int W_BOX = 64 * WG_BK * 2;           // one 64 n x 64 k box, 8 KB
constexpr int W_TILE = (WG_BN / 64) * W_BOX;    // 32 KB
constexpr int MASK_TILE = WG_BK * 4;
constexpr int WG_SMEM = 1024 +                  // alignment slack
                        WG_STAGES * (2 * X_TILE + W_TILE + MASK_TILE) +
                        2 * WG_STAGES * 8;

struct WgmmaGeom {
  int rows, K, Nout;
  int x_cand_rows, mul_cand_rows, mask_cand;   // 0 = shared
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// wgmma descriptor of a B tile in shared memory, N-major with the 128-byte
// swizzle: 64-column boxes of 64 k rows of 128 bytes.  The leading byte
// offset steps 64 columns (one box, 8192 bytes), the stride byte offset
// 8 k rows (one swizzle atom, 1024 bytes); both in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(W_BOX >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// d[64 x 256] += A[64 x 16] (registers) * B[16 x 256] (shared, N-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a thread's A fragment of one 16-k step, gated (and multiplied) with the
// rounding of the reference: registers 0 and 1 hold k 2t, 2t+1 of rows g
// and g+8, registers 2 and 3 the same rows at k + 8
template <int KIND, bool MUL>
__device__ __forceinline__ void gate_fragment(const uint32_t (&xr)[4],
                                              const uint32_t (&ur)[4],
                                              float2 mlo, float2 mhi,
                                              uint32_t (&ar)[4]) {
  float v[8];
  if (KIND == kSilu) {
    // four values (two registers) at a time, each four with one mask pair
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 mh = h == 0 ? mlo : mhi;
      float vh[4] = {__uint_as_float(xr[2 * h] << 16),
                     __uint_as_float(xr[2 * h] & 0xFFFF0000u),
                     __uint_as_float(xr[2 * h + 1] << 16),
                     __uint_as_float(xr[2 * h + 1] & 0xFFFF0000u)};
      const float mv[4] = {mh.x, mh.y, mh.x, mh.y};
      gate_n<KIND, 4>(vh, mv);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * h + e] = vh[e];
    }
  } else {
    // the other kinds one value at a time: eight tanh chains at once spill
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = gate<KIND>(__uint_as_float(xr[q] << 16),
                            q < 2 ? mlo.x : mhi.x);
      v[2 * q + 1] = gate<KIND>(__uint_as_float(xr[q] & 0xFFFF0000u),
                                q < 2 ? mlo.y : mhi.y);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (MUL) {
      v[2 * q] = __fmul_rn(bf16_round(v[2 * q]),
                           __uint_as_float(ur[q] << 16));
      v[2 * q + 1] = __fmul_rn(bf16_round(v[2 * q + 1]),
                               __uint_as_float(ur[q] & 0xFFFF0000u));
    }
    ar[q] = pack_bf16x2(v[2 * q], v[2 * q + 1]);
  }
}

template <int KIND, bool MUL>
__global__ void __launch_bounds__(WG_THREADS, 1)
gate_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_mul,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_mask,
                         __nv_bfloat16* __restrict__ out,
                         const WgmmaGeom g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;
  uint8_t* us = xs + WG_STAGES * X_TILE;
  uint8_t* ws = us + WG_STAGES * X_TILE;
  float* ms = reinterpret_cast<float*>(ws + WG_STAGES * W_TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ms + WG_STAGES * WG_BK);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * WG_BN;
  const int m0 = blockIdx.y * WG_BM;
  const int cand = blockIdx.z;
  const int KT = (g.K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    // ---- producer: one thread keeps the ring full; its warpgroup gives
    // its registers to the consumers (one big branch each, never rejoined)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == WG_CONSUMERS) {
      const int xrow = cand * g.x_cand_rows + m0;
      const int urow = cand * g.mul_cand_rows + m0;
      const int mrow = cand * g.mask_cand;
      const uint32_t bytes =
          (MUL ? 2 : 1) * X_TILE + W_TILE + MASK_TILE;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], ((kt / WG_STAGES) + 1) & 1);
        const int k0 = kt * WG_BK;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(xs + s * X_TILE, &tm_x, k0, xrow, &full[s]);
        if (MUL) tma_load_2d(us + s * X_TILE, &tm_mul, k0, urow, &full[s]);
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j)
          tma_load_2d(ws + s * W_TILE + j * W_BOX, &tm_w, n0 + 64 * j, k0,
                      &full[s]);
        tma_load_2d(ms + s * WG_BK, &tm_mask, k0, mrow, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = tid >> 7;
  const int wi = (tid >> 5) & 3;
  const int lane = tid & 31;
  // ldmatrix.x4 address of this lane: matrix lane/8 (rows +8 for odd
  // matrices, k +8 for the upper two), row lane%8 of it; the tile's 128-byte
  // swizzle moves 16-byte chunk c of row r to chunk c ^ (r % 8)
  const int mat = lane >> 3;
  const int a_row = 64 * wg + 16 * wi + (lane & 7) + ((mat & 1) << 3);
  const uint32_t a_off = a_row * 128;
  const int a_hi = mat >> 1;
  const int a_sw = lane & 7;
  const int t2 = 2 * (lane & 3);

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_reg(d[i]);
  uint32_t a[2][4] = {};

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    const uint32_t xb = smem_u32(xs + s * X_TILE) + a_off;
    const uint32_t ub = smem_u32(us + s * X_TILE) + a_off;
    const uint32_t wb = smem_u32(ws + s * W_TILE);
    const float* mk = ms + s * WG_BK;
#pragma unroll
    for (int j = 0; j < WG_BK / 16; ++j) {
      const uint32_t chunk = ((2 * j + a_hi) ^ a_sw) << 4;
      uint32_t xr[4], ur[4] = {};
      ldmatrix_x4(xb + chunk, xr);
      if (MUL) ldmatrix_x4(ub + chunk, ur);
      const float2 mlo = *reinterpret_cast<const float2*>(mk + 16 * j + t2);
      const float2 mhi =
          *reinterpret_cast<const float2*>(mk + 16 * j + 8 + t2);
      uint32_t(&ar)[4] = a[j & 1];
      gate_fragment<KIND, MUL>(xr, ur, mlo, mhi, ar);
      wgmma_fence();
      // 16 k rows of 128 bytes further into the w tile
      wgmma_m64n256k16(d, ar, b_desc(wb + j * 16 * 128));
      wgmma_commit();
      wgmma_wait<1>();
      // the previous step's product has completed: its fragment registers
      // are free, and after step 0 so is the previous stage
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_reg(a[(j + 1) & 1][q]);
      if (j == 0 && kt > 0 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_reg(d[i]);

  // accumulator i of this thread: row lane/4 (+8 when i%4 >= 2) of the
  // warp's 16, columns 8*(i/4) + 2*(lane%4) + i%2
  const long long row0 = (long long)m0 + 64 * wg + 16 * wi + (lane >> 2);
  __nv_bfloat16* out_c = out + (long long)cand * g.rows * g.Nout;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const long long row = row0 + ((i & 2) ? 8 : 0);
    const int col = n0 + 8 * (i >> 2) + t2;
    if (row < g.rows && col < g.Nout)
      *reinterpret_cast<uint32_t*>(out_c + row * g.Nout + col) =
          pack_bf16x2(d[i], d[i + 1]);
  }
}

// ------------------------------------------------------------------ host

template <int KIND, bool MUL>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tu,
                 const CUtensorMap& tw, const CUtensorMap& tm, void* out,
                 int n_cand, const WgmmaGeom& g, cudaStream_t stream) {
  auto kernel = gate_matmul_wgmma_kernel<KIND, MUL>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((g.Nout + WG_BN - 1) / WG_BN),
            (unsigned)((g.rows + WG_BM - 1) / WG_BM), (unsigned)n_cand);
  kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tx, tu, tw, tm, static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_wgmma_mul(bool mul, const CUtensorMap& tx, const CUtensorMap& tu,
                     const CUtensorMap& tw, const CUtensorMap& tm, void* out,
                     int n_cand, const WgmmaGeom& g, cudaStream_t stream) {
  return mul ? launch_wgmma<KIND, true>(tx, tu, tw, tm, out, n_cand, g, stream)
             : launch_wgmma<KIND, false>(tx, tu, tw, tm, out, n_cand, g,
                                         stream);
}

}  // namespace

// Route A of masked_act_matmul_launch: bfloat16 x, mul, w and out, float32
// mask.  Refuses (cudaErrorInvalidValue) what it cannot take: K or N_out not
// a multiple of 8, an operand not 16-byte aligned, a candidate stride other
// than 0 or rows*K (K for the mask), more rows than a TMA coordinate holds.
int masked_act_matmul_wgmma_launch(const void* x, const void* mask,
                                   const void* mul, const void* w, void* out,
                                   int n_cand, long long rows, int K,
                                   int Nout, long long x_cand_stride,
                                   long long mul_cand_stride,
                                   long long mask_cand_stride, int kind,
                                   cudaStream_t stream) {
  const long long per = rows * (long long)K;
  const bool ok =
      K % 8 == 0 && Nout % 8 == 0 && aligned16(x) && aligned16(mask) &&
      aligned16(w) && aligned16(out) && (mul == nullptr || aligned16(mul)) &&
      (x_cand_stride == 0 || x_cand_stride == per) &&
      (mul_cand_stride == 0 || mul_cand_stride == per) &&
      (mask_cand_stride == 0 || mask_cand_stride == K) &&
      rows * (long long)n_cand <= 2147483647LL && kind >= 0 && kind <= 3;
  if (!ok) return (int)cudaErrorInvalidValue;
  const long long x_rows = x_cand_stride ? rows * n_cand : rows;
  const long long u_rows = mul_cand_stride ? rows * n_cand : rows;
  const int m_rows = mask_cand_stride ? n_cand : 1;
  CUtensorMap tx, tu, tw, tm;
  bool enc =
      encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, x_rows, WG_BK,
                WG_BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, Nout, K, 64,
                WG_BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mask, K, m_rows,
                WG_BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (enc && mul != nullptr)
    enc = encode_2d(&tu, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, mul, K, u_rows,
                    WG_BK, WG_BM, CU_TENSOR_MAP_SWIZZLE_128B);
  else
    tu = tx;   // unused
  if (!enc) return (int)cudaErrorInvalidValue;
  WgmmaGeom g{(int)rows, K, Nout, x_cand_stride ? (int)rows : 0,
              mul_cand_stride ? (int)rows : 0, mask_cand_stride ? 1 : 0};
  switch (kind) {
    case kRelu:
      return launch_wgmma_mul<kRelu>(mul != nullptr, tx, tu, tw, tm, out,
                                     n_cand, g, stream);
    case kGelu:
      return launch_wgmma_mul<kGelu>(mul != nullptr, tx, tu, tw, tm, out,
                                     n_cand, g, stream);
    case kSilu:
      return launch_wgmma_mul<kSilu>(mul != nullptr, tx, tu, tw, tm, out,
                                     n_cand, g, stream);
    default:
      return launch_wgmma_mul<kSqrelu>(mul != nullptr, tx, tu, tw, tm, out,
                                       n_cand, g, stream);
  }
}
