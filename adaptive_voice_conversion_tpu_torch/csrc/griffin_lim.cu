// Fused Griffin-Lim phase iterations in frame space, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `griffin_lim_phases_pallas`
// in adaptive_voice_conversion_tpu/kernels/griffin_lim.py. It computes the
// same thing with the same bf16 rounding points; the f32 summation order
// and the projection's last few ulp differ.
//
// State: re, im, mag are (M, F) f32, M = stacked utterances (or segments),
// each a block of t_pad frame rows; F = f_pad = 1152 frequency columns.
// Basis: cs = [w*cos | -w*sin], (S, 2F), S = s_pad = 1280 samples of the
// window support. One iteration:
//   (1) a_syn = bf16([re*ck | im*ck])                      (M, 2F)
//   (2) syn   = a_syn x cs^T, f32 accumulation              (M, S)
//   (3) acc   = the overlap-add of syn's rows at hop samples a frame, read
//       back frame by frame, inside each t_pad block (the band never
//       crosses utterances); a_ana = bf16(acc * g)           (M, S)
//   (4) [re2 | im2] = a_ana x cs, f32 accumulation          (M, 2F)
//   (5) (re, im) = mag * (re2, im2) / max(|(re2, im2)|, 1e-8)
//
// What bounds it on the H100. The two bf16 products are 2*2*M*S*2F FLOP an
// iteration (48.3 GFLOP at the serving grid's M = 4096: 49 us at the 989
// TFLOP/s tensor-core peak), but no product here runs at that peak: an SM
// takes operand tiles in from L2 at ~60-70 GB/s whoever asks for them (a
// basis tile multicast to a cluster of two blocks was slower, not faster),
// so a block's k-step costs its tile's rows, (BM + BN) x 128 bytes, and the
// rate is set by FLOP per byte taken in: 43 for a 64 x 128 tile, 98 for
// 256 x 160. After that come the rounds (blocks / 132 SMs, rounded up: a
// last round with few blocks costs a whole one) and the epilogues, in which
// every block of a round reads or writes device memory at once while the
// tensor cores wait. The TPU kept the 5.9 MB basis and all state in VMEM; a
// Hopper block has 227 KB of shared memory, so here basis, state and
// scratch live in device memory (L2 at few rows) and three launches make an
// iteration.
//
// What the design does about it.
// - Operand images. Every bf16 operand (a_syn, a_ana, and the two forms of
//   the basis made once by gl_tile_bases) is kept in device memory as wgmma
//   reads it from shared memory: k tile by k tile, each a (rows x 64)
//   matrix of 128-byte rows in the 128-byte swizzle (image_offset). Any run
//   of rows of one k tile is contiguous, so a stage of a block's pipeline is
//   two or three 1-D bulk copies (cp.async.bulk, the TMA engine without a
//   tensor map) whatever the tile's size, completed on an mbarrier.
// - gl_gemm, both products. Warp-specialised: one producer thread only
//   starts the copies, up to 8 stages ahead, on full/empty mbarriers; one
//   or two consumer warpgroups run wgmma (64 x BN x 16, B shared by the
//   one or two 64-row instructions of a warpgroup) with a group left in
//   flight, registers handed over with setmaxnreg. Tiles from 64 x 128 to
//   256 x 160; the basis tiles of a block's first stages are asked for
//   before the block waits for the launch before it.
// - The launch plan (make_plan; launch_plan in kernels/griffin_lim.py is
//   its mirror) picks each product's tile, and whether K of the syn product
//   is split, from M by a cost model in the units above: at M = 4096, 256 x
//   160 syn tiles (128 blocks, one round) and 256 x 144 ana tiles (256
//   blocks, two rounds); at one utterance (M = 344), 128 x 128 syn tiles x
//   4 parts of K (120 blocks) and 64 x 128 ana tiles (108 blocks), as
//   "light" blocks that leave registers and shared memory for the blocks of
//   the next launch to start beside them.
// - No dead bytes. re/im f32 are stored by the last iteration only; K of
//   the syn product is split (partial sums in device memory) only where the
//   tiles alone cannot fill the SMs; the band pass reads every syn element
//   once (9 taps read 9 times before) and writes a_ana once; the ana
//   epilogue projects in place from a tile staged in shared memory with
//   16-byte accesses, its magnitudes asked of L2 when the block starts.
// - Three launches per iteration on the caller's stream (gl_gemm, gl_band,
//   gl_gemm), each a programmatic dependent launch, plus gl_prep once.
//
// Tried and taken out: clusters of two with the basis tile multicast (see
// above); an ana kernel of one block per SM walking 128 x 192 tiles with a
// fourth warpgroup for the epilogue (the epilogue then overlapped the next
// tile's main loop, but the smaller tiles' extra bytes cost what that
// saved); and, at few rows, the whole loop as one cooperative launch with
// grid barriers between the phases (a barrier cost ~3 us, more than the
// launch boundary it replaced). Not done: a launch in which every t_pad
// block of rows runs its own chain of phases, which their independence
// would allow (a block of rows needs no other block's rows in any phase).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;           // contraction depth of one stage: 128 bytes of bf16
constexpr int ROW_BYTES = 128;   // one image row of one k tile
constexpr int TILE_ROWS = 256;   // A images hold M rounded up to a multiple of this
constexpr int EW = 256;          // threads of an elementwise block
constexpr int NUM_SMS = 132;     // the launch plan is tuned for the H100 SXM
// The plan's cost model (see gemm_cost), in 128-byte operand rows: a block's
// start, the epilogues per tile column of a 128-row tile, a part of K per
// 128 rows of partial sums.
constexpr int PLAN_START = 500;
constexpr int PLAN_EPI_SYN = 8;
constexpr int PLAN_EPI_ANA = 16;
constexpr int PLAN_SPLIT = 80;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take
constexpr int MAX_STAGES = 8;
constexpr int LIGHT_STAGES = 4;   // of a block that leaves room beside it
constexpr int BAR_BYTES = 256;   // full[] and empty[] mbarriers

// Bytes of one pipeline stage and the depth that fits, for a (bm x bn) block tile.
__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * ROW_BYTES; }
__host__ __device__ constexpr int n_stages(int bm, int bn, bool light) {
  const int fit = (SMEM_LIMIT - 1024 - BAR_BYTES) / stage_bytes(bm, bn);
  const int cap = light ? LIGHT_STAGES : MAX_STAGES;
  return fit > cap ? cap : fit;
}
__host__ __device__ constexpr int smem_bytes(int bm, int bn, bool light) {
  return n_stages(bm, bn, light) * stage_bytes(bm, bn) + 1024 + BAR_BYTES;
}

// Element (row, k) of an operand image with `rows` rows: k tile by k tile,
// each a (rows x 64) row-major matrix of 128-byte rows whose 16-byte pieces
// are swizzled by the row (wgmma's 128-byte swizzle, K-major).
__host__ __device__ __forceinline__ size_t image_offset(int row, int k, int rows) {
  return ((size_t)(k >> 6) * rows + row) * 64 + ((((k >> 3) & 7) ^ (row & 7)) << 3) + (k & 7);
}

// The two B operands from the basis cs (S, 2F) bf16, row-major: syn_b is
// the image of cs (rows = samples, K = 2F), ana_b the image of cs^T (rows =
// the 2F columns of cs, K = S).
__global__ void gl_tile_bases_kernel(const bf16* __restrict__ cs,
                                     bf16* __restrict__ syn_b,
                                     bf16* __restrict__ ana_b, int F, int S) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * 2 * F) return;
  int s = idx / (2 * F), c = idx - s * 2 * F;
  syn_b[image_offset(s, c, S)] = cs[idx];
  ana_b[image_offset(c, s, 2 * F)] = cs[idx];
}

// 8 adjacent floats (16-byte aligned) as two 16-byte accesses.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
// bf16(a * s), bf16(b * t) packed in element order.
__device__ __forceinline__ uint32_t bf16x2(float a, float s, float b, float t) {
  __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(a, s), __fmul_rn(b, t));
  return *reinterpret_cast<uint32_t*>(&h);
}
// bf16(v[j] * s[j]) for j = 0..7, packed in element order.
__device__ __forceinline__ uint4 bf16x8(const float (&v)[8], const float (&s)[8]) {
  return make_uint4(bf16x2(v[0], s[0], v[1], s[1]), bf16x2(v[2], s[2], v[3], s[3]),
                    bf16x2(v[4], s[4], v[5], s[5]), bf16x2(v[6], s[6], v[7], s[7]));
}

// (1): a_syn[m, k] = bf16(re[m, k]*ck[k]), a_syn[m, F + k] = bf16(im*ck),
// into the image of rows_a rows. A thread makes 8 adjacent columns.
__global__ void gl_prep(const float* __restrict__ re,
                        const float* __restrict__ im,
                        const float* __restrict__ ck,
                        bf16* __restrict__ a_syn, int M, int F, int rows_a) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * (F / 8)) return;
  int m = idx / (F / 8), k = (idx - m * (F / 8)) * 8;
  float c[8], v[8];
  load8(c, ck + k);
  load8(v, re + (size_t)m * F + k);
  *reinterpret_cast<uint4*>(a_syn + image_offset(m, k, rows_a)) = bf16x8(v, c);
  load8(v, im + (size_t)m * F + k);
  *reinterpret_cast<uint4*>(a_syn + image_offset(m, F + k, rows_a)) = bf16x8(v, c);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch: the loop's launches may start while the
// previous one runs. A kernel reads no output of earlier launches, and
// writes nothing, before wait_prior_grid(); every block calls it, so that a
// grid's end implies the end of all grids before it.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One 1-D bulk copy global -> shared (addresses in the shared window),
// counted on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// wgmma descriptor of a K-major operand tile in the 128-byte swizzle: rows
// of 128 bytes, 8-row groups 1024 bytes apart (the stride byte offset; the
// leading byte offset is unused in this mode), `addr` 1024-byte aligned
// plus 32 bytes per k16 slice.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N f32, spread over the warpgroup) += A (64 x 16) x B (N x 16)^T
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<144>(float (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<160>(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct GemmArgs {
  const bf16* a;      // A image, rows_a rows
  const bf16* b;      // B image, rows_b rows
  float* syn;         // syn product: (split, M, S) f32 partial sums
  const float* mag;   // ana product: the projection's inputs and outputs
  const float* ck;
  float* re;
  float* im;
  bf16* a_syn;
  int M, rows_a, rows_b, F, S, k_tiles, last;
};

// All consumer warpgroups of a block meet here (the producer does not).
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// One k-step of a consumer warpgroup: MI x 4 wgmma (64 x BN x 16 each) on
// the stage's tiles, committed as one group.
template <int MI, int BN>
__device__ __forceinline__ void mma_stage(float (&d)[MI][BN / 2], uint32_t a_tile,
                                          uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < MI; ++i) fence_acc(d[i]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < BK / 16; ++k)
#pragma unroll
    for (int i = 0; i < MI; ++i)
      wgmma<BN>(d[i], tile_desc(a_tile + i * (64 * ROW_BYTES) + 32 * k),
                tile_desc(b_tile + 32 * k));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// A consumer's accumulators into the staged (BM x BN) f32 tile Cs, rows
// BN + 8 floats apart (no bank conflicts for these 8-byte writes nor for
// the 16-byte reads of project_item). Thread t of a warpgroup holds, for
// each 8-column block j, rows 16*(t/32) + (t%32)/4 (+8) and columns
// 8j + 2*(t%4) (+1); `row` is the first of them in the tile.
template <int MI, int BN>
__device__ __forceinline__ void stage_tile(float* Cs, const float (&d)[MI][BN / 2], int row) {
  constexpr int LDC = BN + 8;
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float* dst = Cs + (row + 64 * i) * LDC + 8 * j + c0;
      *reinterpret_cast<float2*>(dst) = make_float2(d[i][4 * j], d[i][4 * j + 1]);
      *reinterpret_cast<float2*>(dst + 8 * LDC) = make_float2(d[i][4 * j + 2], d[i][4 * j + 3]);
    }
}

// (5) for the 8 adjacent columns f.. of row m, from row r and column group
// g of the staged tile (re2 | im2) and the row's magnitudes mg: projects,
// writes the next iteration's bf16 synthesis operand and, on the last
// iteration, the f32 state.
template <int BN>
__device__ __forceinline__ void project_item(const GemmArgs& p, const float* Cs, int r, int g,
                                             int m, int f, const float (&mg)[8]) {
  constexpr int LDC = BN + 8, H = BN / 2;
  float nre[8], nim[8], c_k[8];
  load8(nre, Cs + r * LDC + 8 * g);      // re2
  load8(nim, Cs + r * LDC + H + 8 * g);  // im2
  load8(c_k, p.ck + f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // mag / max(|X2|, 1e-8) through one approximate reciprocal square
    // root (a few ulp) instead of an IEEE square root and two divisions
    float ss = __fadd_rn(__fmul_rn(nre[j], nre[j]), __fmul_rn(nim[j], nim[j]));
    float scale = __fmul_rn(mg[j], ss > 1e-16f ? rsqrtf(ss) : 1e8f);
    nre[j] = __fmul_rn(nre[j], scale);
    nim[j] = __fmul_rn(nim[j], scale);
  }
  if (p.last) {
    store8(p.re + (size_t)m * p.F + f, nre);
    store8(p.im + (size_t)m * p.F + f, nim);
  }
  *reinterpret_cast<uint4*>(p.a_syn + image_offset(m, f, p.rows_a)) = bf16x8(nre, c_k);
  *reinterpret_cast<uint4*>(p.a_syn + image_offset(m, p.F + f, p.rows_a)) = bf16x8(nim, c_k);
}

// The epilogue of a staged (BM x BN) ana tile at rows m0.., column tile nt,
// by THREADS threads of which this is thread `tid`: a thread takes 8
// adjacent columns of a row at a time, ITEMS of them, all their magnitudes
// loaded before the first is used.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void project_tile(const GemmArgs& p, const float* Cs, int m0, int nt,
                                             int tid) {
  constexpr int H = BN / 2, GROUPS = H / 8;
  constexpr int ITEMS = (BM * GROUPS + THREADS - 1) / THREADS;
  float mg[ITEMS][8];
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    const int item = tid + e * THREADS;
    const int m = m0 + item / GROUPS, f = nt * H + 8 * (item % GROUPS);
    if (item < BM * GROUPS && m < p.M) {
      load8(mg[e], p.mag + (size_t)m * p.F + f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) mg[e][j] = 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    const int item = tid + e * THREADS;
    const int r = item / GROUPS, g = item % GROUPS;
    if (item < BM * GROUPS && m0 + r < p.M)
      project_item<BN>(p, Cs, r, g, m0 + r, nt * H + 8 * g, mg[e]);
  }
}

// Asks L2 for the magnitudes of the (BM x BN/2) ana tile at rows m0..,
// column tile nt (an input: no launch wrote it), one 128-byte line per
// `step`-th call index i; rows of mag start on lines (F % 32 == 0).
template <int BM, int BN>
__device__ __forceinline__ void prefetch_mag(const GemmArgs& p, int m0, int nt, int i0, int step) {
  constexpr int H = BN / 2;
  const int line0 = nt * H / 32, lines = (nt * H + H - 1) / 32 - line0 + 1;
  for (int i = i0; i < BM * lines; i += step) {
    const int m = m0 + i / lines;
    if (m < p.M)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p.mag + (size_t)m * p.F +
                                                    32 * (line0 + i % lines)));
  }
}

// Both products: a (BM x BN) tile of A (M x K) x B (N x K)^T, BM = 64 * WGS
// * MI, f32 accumulators in registers. Warp-specialised: warpgroups
// 0..WGS-1 are consumers, each MI x 64 rows of the tile (MI wgmma per k16,
// sharing the B tile); one thread of the last warpgroup is the producer,
// which only starts bulk copies, STAGES ahead: stage s is filled when
// full[s] completes and may be refilled when empty[s] does (one arrival per
// consumer warp). LIGHT blocks (a grid of one round at few rows) keep to
// the registers they were launched with and to 4 stages, so that blocks of
// the next launch fit beside them and start early.
//   ANA = false, (2): syn_z (M, S) = a_syn[:, kz] x cs[:, kz]^T for part z =
//     blockIdx.z of K = 2F; grid (M tiles, S / BN, split).
//   ANA = true, (4)+(5): the block at column tile ft holds re2 columns
//     f0..f0+BN/2-1 and im2 columns F+f0.. (f0 = ft * BN/2: two pieces of
//     ana_b). The epilogue stages the tile in shared memory, projects onto
//     the magnitude 8 columns a thread with 16-byte accesses, writes the
//     next iteration's bf16 synthesis operand, and on the last iteration
//     the f32 state.
template <int WGS, int MI, int BN, bool ANA, bool LIGHT>
__global__ void __launch_bounds__(128 * (WGS + 1), 1) gl_gemm(const GemmArgs p) {
  constexpr int BM = 64 * WGS * MI;
  constexpr int STAGES = n_stages(BM, BN, LIGHT);
  constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int H = BN / 2;
  constexpr int CONSUMERS = 128 * WGS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * STAGE, empty = full + 8 * STAGES;
  const int m0 = blockIdx.x * BM, nt = blockIdx.y;
  const int ksteps = p.k_tiles / gridDim.z, t0 = blockIdx.z * ksteps;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the two roles never meet again (setmaxnreg needs that)
  if (wg == WGS) {
    if constexpr (!LIGHT) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      auto load_b = [&](int s, int kt) {
        const uint32_t dst = base + s * STAGE + A_BYTES, bar = full + 8 * s;
        const bf16* tile = p.b + (size_t)kt * p.rows_b * BK;
        if constexpr (ANA) {
          bulk_load(dst, tile + (size_t)(nt * H) * BK, B_BYTES / 2, bar);
          bulk_load(dst + B_BYTES / 2, tile + (size_t)(p.F + nt * H) * BK, B_BYTES / 2, bar);
        } else {
          bulk_load(dst, tile + (size_t)(nt * BN) * BK, B_BYTES, bar);
        }
      };
      auto load_a = [&](int s, int kt) {
        bulk_load(base + s * STAGE, p.a + ((size_t)kt * p.rows_a + m0) * BK, A_BYTES,
                  full + 8 * s);
      };
      // the basis is no output of an earlier launch: its first tiles are
      // on their way before this one waits for the launch before it
      const int ahead = ksteps < STAGES ? ksteps : STAGES;
      for (int ks = 0; ks < ahead; ++ks) {
        mbar_expect_tx(full + 8 * ks, STAGE);
        load_b(ks, t0 + ks);
      }
      wait_prior_grid();
      for (int ks = 0; ks < ahead; ++ks) load_a(ks, t0 + ks);
      for (int ks = ahead; ks < ksteps; ++ks) {
        const int s = ks % STAGES;
        mbar_wait(empty + 8 * s, (ks / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, STAGE);
        load_b(s, t0 + ks);
        load_a(s, t0 + ks);
      }
    } else if constexpr (ANA) {
      // the other threads of this warpgroup ask L2 for the magnitudes that
      // the epilogue will read
      prefetch_mag<BM, BN>(p, m0, nt, threadIdx.x - CONSUMERS - 1, 127);
    }
  } else {
    if constexpr (!LIGHT) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    wait_prior_grid();
    const int lane = threadIdx.x & 31;
    float d[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) d[i][r] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(full + 8 * s, (ks / STAGES) & 1);
      const uint32_t a_tile = base + s * STAGE + wg * (MI * 64 * ROW_BYTES);
      const uint32_t b_tile = base + s * STAGE + A_BYTES;
      mma_stage<MI, BN>(d, a_tile, b_tile);
      // one group stays in flight; the one before it has read its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * ((ks - 1) % STAGES));
      __syncwarp();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_acc(d[i]);

    // the first of this thread's rows in the tile (see stage_tile)
    const int row = wg * (MI * 64) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    if constexpr (!ANA) {
      float* out = p.syn + (size_t)blockIdx.z * p.M * p.S + nt * BN + c0;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = m0 + row + 64 * i;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (m < p.M)
            *reinterpret_cast<float2*>(out + (size_t)m * p.S + 8 * j) =
                make_float2(d[i][4 * j], d[i][4 * j + 1]);
          if (m + 8 < p.M)
            *reinterpret_cast<float2*>(out + (size_t)(m + 8) * p.S + 8 * j) =
                make_float2(d[i][4 * j + 2], d[i][4 * j + 3]);
        }
      }
    } else {
      // every consumer is done with the pipeline's stages: the tile is
      // staged over them
      static_assert(BM * (BN + 8) * 4 <= STAGES * STAGE, "the staged tile must fit in the pipeline");
      float* Cs = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
      consumer_sync<CONSUMERS>();
      stage_tile<MI, BN>(Cs, d, row);
      consumer_sync<CONSUMERS>();
      project_tile<BM, BN, CONSUMERS>(p, Cs, m0, nt, threadIdx.x);
    }
  }
}

// (3): the banded overlap-add and re-framing, then the analysis gain, as an
// overlap-add into the 1-D signal of each t_pad block and its re-framing:
//   y[p] = sum over frames t of the block with 0 <= p - t*hop < S of
//          syn[t, p - t*hop]   (the split's partial sums of a frame first,
//          then the frames in rising order: a fixed order),
//   a_ana[t, n] = bf16(y[t*hop + n] * g[n]).
// A thread makes 4 adjacent positions p (hop % 4 == 0 and S % 4 == 0 keep
// them in one frame's row at every t), reads each syn element once and
// writes every a_ana element once. Grid (blocks of rows, chunks of p);
// SPLIT = the parts of the syn product's K.
template <int SPLIT>
__global__ void gl_band(const float* __restrict__ syn, const float* __restrict__ g,
                        bf16* __restrict__ a_ana, int M, int rows_a, int S, int t_pad,
                        int hop) {
  constexpr int FR = SPLIT > 3 ? 3 : 5;
  wait_prior_grid();
  const int p = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (p >= (t_pad - 1) * hop + S) return;
  const int row0 = blockIdx.x * t_pad;
  const int t_lo = p > S - 4 ? (p - (S - 4) + hop - 1) / hop : 0;
  const int t_hi = p / hop < t_pad - 1 ? p / hop : t_pad - 1;
  const size_t MS = (size_t)M * S;
  float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // FR frames at a time, all their loads started before the sums
  for (int tb = t_lo; tb <= t_hi; tb += FR) {
    float4 v[FR][SPLIT];
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const int t = tb + i <= t_hi ? tb + i : t_hi;  // a frame read twice is not summed twice
      const float* src = syn + (size_t)(row0 + t) * S + (p - t * hop);
#pragma unroll
      for (int z = 0; z < SPLIT; ++z) v[i][z] = *reinterpret_cast<const float4*>(src + z * MS);
    }
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      if (tb + i > t_hi) break;
      float4 s = v[i][0];
#pragma unroll
      for (int z = 1; z < SPLIT; ++z)
        s = make_float4(__fadd_rn(s.x, v[i][z].x), __fadd_rn(s.y, v[i][z].y),
                        __fadd_rn(s.z, v[i][z].z), __fadd_rn(s.w, v[i][z].w));
      y = tb + i == t_lo ? s
                         : make_float4(__fadd_rn(y.x, s.x), __fadd_rn(y.y, s.y),
                                       __fadd_rn(y.z, s.z), __fadd_rn(y.w, s.w));
    }
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int n = p - t * hop;
    const float4 gv = *reinterpret_cast<const float4*>(g + n);
    *reinterpret_cast<uint2*>(a_ana + image_offset(row0 + t, n, rows_a)) =
        make_uint2(bf16x2(y.x, gv.x, y.y, gv.y), bf16x2(y.z, gv.z, y.w, gv.w));
  }
}

// How gl_run launches the two products at M rows: block tile rows and
// columns of each, and the parts of the syn product's K.
struct Plan {
  int syn_bm, syn_bn, syn_split, ana_bm, ana_bn;
};

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The plan's cost model, in units of one 128-byte operand row pulled into
// an SM (what bounds a block's k-step): rounds of blocks on the SMs x (a
// block's k-steps x the rows of a stage + its epilogue + its start), plus
// what the band pays for reading partial sums. Mirrored by launch_plan in
// kernels/griffin_lim.py.
long gemm_cost(int M, int n_cols, int k_tiles, int bm, int bn, int split, int epi) {
  const long blocks = (long)ceil_div(M, bm) * (n_cols / bn) * split;
  const long rounds = (blocks + NUM_SMS - 1) / NUM_SMS;
  return rounds * ((long)(k_tiles / split) * (bm + bn) + (long)epi * bn * bm / 128 + PLAN_START) +
         (split > 1 ? (long)PLAN_SPLIT * ceil_div(M, 128) * split : 0);
}

Plan g_last = {0, 0, 0, 0, 0};
bool g_overlap = true;  // see gl_set_launch_overlap

const int SYN_TILES[][2] = {{128, 128}, {128, 160}, {128, 256}, {256, 160}};
const int ANA_TILES[][2] = {{64, 128}, {128, 128}, {128, 192}, {128, 256}, {256, 144}};
const int SPLITS[] = {1, 2, 3, 4, 6};

bool make_plan(int M, int F, int S, Plan* plan) {
  long best = LONG_MAX;
  for (const auto& t : SYN_TILES) {
    if (S % t[1] != 0) continue;
    for (int split : SPLITS) {
      const int blocks = ceil_div(M, t[0]) * (S / t[1]);
      if ((2 * F / BK) % split != 0) continue;
      // K is split only where the tiles alone cannot fill the SMs
      if (split > 1 && (blocks >= NUM_SMS || blocks * split > NUM_SMS)) continue;
      const long c = gemm_cost(M, S, 2 * F / BK, t[0], t[1], split, PLAN_EPI_SYN);
      if (c < best) {
        best = c;
        plan->syn_bm = t[0]; plan->syn_bn = t[1]; plan->syn_split = split;
      }
    }
  }
  if (best == LONG_MAX) return false;
  best = LONG_MAX;
  for (const auto& t : ANA_TILES) {
    if (F % (t[1] / 2) != 0) continue;
    const long c = gemm_cost(M, 2 * F, S / BK, t[0], t[1], 1, PLAN_EPI_ANA);
    if (c < best) {
      best = c;
      plan->ana_bm = t[0]; plan->ana_bn = t[1];
    }
  }
  return best != LONG_MAX;
}

typedef void (*GemmKernel)(const GemmArgs);
typedef void (*BandKernel)(const float*, const float*, bf16*, int, int, int, int, int);

struct GemmLaunch {
  GemmKernel kernel;
  int threads, smem;
};

template <int WGS, int MI, int BN, bool ANA, bool LIGHT>
GemmLaunch gemm_launch() {
  return {gl_gemm<WGS, MI, BN, ANA, LIGHT>, 128 * (WGS + 1),
          smem_bytes(64 * WGS * MI, BN, LIGHT)};
}

// The instantiation of a (bm x bn) tile; `light` where the grid is one
// round of blocks and the tile has one; kernel == nullptr if there is none.
GemmLaunch find_gemm(bool ana, int bm, int bn, bool light) {
  if (!ana) {
    if (bm == 128 && bn == 128) return light ? gemm_launch<2, 1, 128, false, true>() : gemm_launch<2, 1, 128, false, false>();
    if (bm == 128 && bn == 160) return light ? gemm_launch<2, 1, 160, false, true>() : gemm_launch<2, 1, 160, false, false>();
    if (bm == 128 && bn == 256) return gemm_launch<2, 1, 256, false, false>();
    if (bm == 256 && bn == 160) return gemm_launch<2, 2, 160, false, false>();
  } else {
    if (bm == 64 && bn == 128) return gemm_launch<1, 1, 128, true, true>();
    if (bm == 128 && bn == 128) return light ? gemm_launch<2, 1, 128, true, true>() : gemm_launch<2, 1, 128, true, false>();
    if (bm == 128 && bn == 192) return gemm_launch<2, 1, 192, true, false>();
    if (bm == 128 && bn == 256) return gemm_launch<2, 1, 256, true, false>();
    if (bm == 256 && bn == 144) return gemm_launch<2, 2, 144, true, false>();
  }
  return {nullptr, 0, 0};
}

BandKernel find_band(int split) {
  switch (split) {
    case 1: return gl_band<1>;
    case 2: return gl_band<2>;
    case 3: return gl_band<3>;
    case 4: return gl_band<4>;
    case 6: return gl_band<6>;
  }
  return nullptr;
}

// Launches kernel with programmatic stream serialization (see
// wait_prior_grid).
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = g_overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

}  // namespace

// The rows an A image is padded to: gl_run's a_syn and a_ana scratch hold
// M rounded up to a multiple of this.
extern "C" int gl_tile_rows() { return TILE_ROWS; }

// The constants of the operand image and of the plan's cost model, for the
// Python model of both: {k tile, SMs, start, syn epilogue, ana epilogue,
// split}.
extern "C" void gl_constants(int* out) {
  out[0] = BK;
  out[1] = NUM_SMS;
  out[2] = PLAN_START;
  out[3] = PLAN_EPI_SYN;
  out[4] = PLAN_EPI_ANA;
  out[5] = PLAN_SPLIT;
}

// The plan gl_run takes at M rows: {syn tile rows, syn tile columns, syn
// split, ana tile rows, ana tile columns}. Returns 0, or 1 if no tile fits
// these widths.
extern "C" int gl_plan(int M, int F, int S, int* out) {
  Plan p;
  if (!make_plan(M, F, S, &p)) return 1;
  out[0] = p.syn_bm; out[1] = p.syn_bn; out[2] = p.syn_split;
  out[3] = p.ana_bm; out[4] = p.ana_bn;
  return 0;
}

// The plan the last gl_run launched, in gl_plan's order.
extern "C" void gl_last_plan(int* out) {
  out[0] = g_last.syn_bm; out[1] = g_last.syn_bn; out[2] = g_last.syn_split;
  out[3] = g_last.ana_bm; out[4] = g_last.ana_bn;
}

// For measurements: with `on` == 0 the loop's launches are plain launches,
// each starting when the one before has ended, so that a profiler's span of
// a launch is its own time. The default is programmatic dependent launch.
extern "C" void gl_set_launch_overlap(int on) { g_overlap = on != 0; }

// The largest row count M that gl_run takes at these widths: the number of
// state elements M * F (gl_prep's flat index, one thread per 8 of them) and
// of 8-column pieces of a synthesis row stay inside an int; every offset
// into an array is a size_t.
extern "C" int gl_max_rows(int F, int S) {
  const int per_row = F > S / 8 ? F : S / 8;
  return per_row > 0 ? (INT_MAX - EW) / per_row : 0;
}

// Writes the images of the plain basis cs (S, 2F) bf16 that gl_run reads:
// syn_b and ana_b (S * 2F bf16 each), on `stream`. Returns cudaGetLastError().
extern "C" int gl_tile_bases(const bf16* cs, bf16* syn_b, bf16* ana_b, int F, int S,
                             void* stream_ptr) {
  if (S % BK != 0 || F % BK != 0) return (int)cudaErrorInvalidValue;
  const int ew = EW;
  gl_tile_bases_kernel<<<(S * 2 * F + ew - 1) / ew, ew, 0,
                         reinterpret_cast<cudaStream_t>(stream_ptr)>>>(cs, syn_b, ana_b, F, S);
  return (int)cudaGetLastError();
}

// Runs n_iter iterations on `stream`. re/im receive the final state (they
// are written by the last iteration only). syn_b and ana_b are the basis
// images made by gl_tile_bases. Scratch, caller-allocated, with R = M
// rounded up to gl_tile_rows(): a_syn (R, 2F) and a_ana (R, S) bf16 images,
// ZEROED (rows M.. are never written and must read as 0); syn (split, M, S)
// f32 with the split of gl_plan. Shapes must satisfy S % 64 == 0,
// F % 64 == 0, hop % 4 == 0, M % t_pad == 0, n_taps == (S - 1) / hop and
// M <= gl_max_rows(F, S) (checked here). Returns cudaGetLastError() after
// the launches, so a refused launch is reported; nothing is synchronised.
extern "C" int gl_run(const float* mag, const float* re0, const float* im0,
                      const bf16* syn_b, const bf16* ana_b, const float* ck,
                      const float* g, float* re, float* im, bf16* a_syn,
                      float* syn, bf16* a_ana, int M, int F, int S, int t_pad,
                      int hop, int n_taps, int n_iter, void* stream_ptr) {
  if (M <= 0 || M > gl_max_rows(F, S) || S % BK != 0 || F % BK != 0 || hop <= 0 ||
      hop % 4 != 0 || t_pad <= n_taps || M % t_pad != 0 || n_taps != (S - 1) / hop ||
      n_iter < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int ew = EW;
  const long band_chunks = (((long)(t_pad - 1) * hop + S) / 4 + ew - 1) / ew;
  Plan plan;
  if (band_chunks > 65535 || !make_plan(M, F, S, &plan)) return (int)cudaErrorInvalidValue;
  const dim3 grid_syn(ceil_div(M, plan.syn_bm), S / plan.syn_bn, plan.syn_split);
  const dim3 grid_ana(ceil_div(M, plan.ana_bm), 2 * F / plan.ana_bn, 1);
  const dim3 grid_band(M / t_pad, (int)band_chunks);
  // a grid of one round leaves room beside its blocks
  const bool light_syn = (long)grid_syn.x * grid_syn.y * grid_syn.z <= NUM_SMS;
  const bool light_ana = (long)grid_ana.x * grid_ana.y <= NUM_SMS;
  const GemmLaunch syn_gemm = find_gemm(false, plan.syn_bm, plan.syn_bn, light_syn);
  const GemmLaunch ana_gemm = find_gemm(true, plan.ana_bm, plan.ana_bn, light_ana);
  const BandKernel band = find_band(plan.syn_split);
  if (!syn_gemm.kernel || !ana_gemm.kernel || !band) return (int)cudaErrorInvalidValue;
  g_last = plan;
  // both products take more than the default 48 KB of dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      syn_gemm.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, syn_gemm.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ana_gemm.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ana_gemm.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int rows_a = ceil_div(M, TILE_ROWS) * TILE_ROWS;
  gl_prep<<<(M * (F / 8) + ew - 1) / ew, ew, 0, stream>>>(re0, im0, ck, a_syn, M, F, rows_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  GemmArgs syn_args = {a_syn, syn_b, syn, nullptr, nullptr, nullptr, nullptr, nullptr,
                       M, rows_a, S, F, S, 2 * F / BK, 0};
  GemmArgs ana_args = {a_ana, ana_b, nullptr, mag, ck, re, im, a_syn,
                       M, rows_a, 2 * F, F, S, S / BK, 0};
  for (int it = 0; it < n_iter && err == cudaSuccess; ++it) {
    ana_args.last = it == n_iter - 1;
    err = launch_pdl(syn_gemm.kernel, grid_syn, syn_gemm.threads, syn_gemm.smem, stream,
                     syn_args);
    if (err == cudaSuccess)
      err = launch_pdl(band, grid_band, ew, 0, stream, syn, g, a_ana, M, rows_a, S, t_pad, hop);
    if (err == cudaSuccess)
      err = launch_pdl(ana_gemm.kernel, grid_ana, ana_gemm.threads, ana_gemm.smem, stream,
                       ana_args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
