// Attention forward for Hopper (sm_90a): TMA ring, wgmma, warp-specialised.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (its pallas_call at :85) for bf16 at head dims 64, 80 and
// 128, the shapes of the models the port serves (Yi-6B, ChatGLM3-6B and
// Granite-20B have d = 128; StableLM-3B's layers and Zamba2-2.7B's shared
// block d = 80). It computes the same function as the mma.sync kernel of
// flash_attention.cu, which keeps fp32 and the other head dims:
// o = softmax(q k^T / sqrt(d) [+ causal mask]) v per (batch, query head); logits, running max m, running sum l and the accumulator in fp32; a
// row with l == 0 gives 0; output bf16. Query head h reads KV head
// h / (Hq / Hkv) in place (GQA), and key positions >= T are masked whether
// causal or not (the Pallas kernel lets its zero padding into a non-causal
// softmax; kernels/ref.flash_attention_ref, the oracle, does not).
//
// Bound: at the Yi-6B prefill shape (B=1, T=4096, Hq=32, Hkv=4, d=128,
// causal) the two products are 4 Hq d T(T+1)/2 = 137.5 GFLOP, 0.139 ms at the
// 989 TFLOP/s bf16 tensor-core rate, against 75.5 MB of q, k, v, o (0.023 ms
// at 3.35 TB/s): bound by tensor-core operations. At Zamba2's prefill shape
// (T=4096, 32/32 heads, d=80) the products are 85.9 GFLOP (0.087 ms), but the
// softmax's 268 M exponentials do not shrink with d: at the ~3.9 T/s of the
// special-function units they take ~0.07 ms more where they do not overlap
// the products.
//
// Design: grid (Hq, ceil(T/128), B), one block of three warpgroups per (head,
// 128-query tile, batch).
//   * Warpgroup 2 is the producer: it drops to 40 registers (setmaxnreg) and
//     one of its threads issues every load with TMA (cp.async.bulk.tensor)
//     into shared memory: Q [128, d] once, then K and V tiles [128 keys, d]
//     into a ring of 2 stages, each with a full and an empty barrier
//     (mbarrier) for K and the same for V, so a stage's K is refilled once S
//     has read it while its V may still be in use. The tensor maps are 4-D over (d, H, T, B),
//     so the T dimension is bounded per batch: rows >= T arrive as zeros (a
//     zero V row times p = 0 stays 0) and never as the next batch's rows.
//     Boxes are 64 columns wide with the 128-byte swizzle (its span), so a
//     d = 128 tile is two boxes. A d = 80 tile is one such box and one box
//     of 16 columns with the 32-byte swizzle (its span, and exactly one k16
//     step of S and one n16 slice of O), from a second tensor map per
//     tensor loaded at column 64: 20 KB per tile. Five 16-column boxes
//     would need one map and one descriptor kind, but would read every
//     operand through the 32-byte swizzle; padding d to 128 would do 1.6x
//     the products.
//   * Warpgroups 0 and 1 are the consumers, 64 query rows each, at 232
//     registers. S = Q K^T is wgmma m64n128k16 with both operands read from
//     shared memory, K-major, through 128-byte-swizzle descriptors (at
//     d = 80 the fifth k16 step reads the narrow boxes through 32-byte-
//     swizzle descriptors); the online softmax runs on the fp32 accumulator
//     in registers (a thread owns rows warp*16 + lane/4 and +8, so a row's
//     max and sum are reduced over the 4 lanes of a quad); P goes to bf16
//     pairs in registers, never through shared memory, and is the register
//     A operand of O += P V, wgmma m64n{d}k16 with V read from shared memory
//     MN-major (imm-trans-b = 1). At d = 80 that is m64n64k16 on the wide
//     box and m64n16k16 on the narrow one, whose 8 accumulators a thread
//     follow the wide product's 32 in one array: the rescale and the
//     write-back index columns 64..79 as they index the rest. A consumer
//     arrives on a stage's K (V) empty barrier once its S (P V) product has
//     read it.
//   * At d <= 80 (S 64 + O 40 + P 32 registers a thread) a tile's S and the
//     previous tile's P V are issued back to back, and the tile's softmax
//     runs while the tensor cores finish that P V; the two consumer
//     warpgroups issue their products in turns (two named barriers), so one
//     warpgroup's softmax also runs under the other's products. At d = 128
//     (S 64 + O 64 + P 32) that overlap makes ptxas serialize the wgmmas for
//     want of registers (C7512) and runs ~25% slower, so d = 128 issues S,
//     waits, runs the softmax, then issues P V and waits.
//   * Causal: only the last tile a block reads (the diagonal) is masked, the
//     block stops at the tile of its last query, the longest query tiles are
//     launched first (blockIdx.y reversed), and the Hq/Hkv query heads that
//     share a KV head are adjacent in the grid so their K/V tiles come from L2.
//   * O is normalised by l in registers and written as bf16 pairs, rows >= T
//     skipped.
// Against the four limits of the mma.sync kernel: wgmma replaces mma.sync
// m16n8k16; the TMA ring with a producer warpgroup overlaps the loads of the
// next tile with the products of this one (there, every tile was loaded by
// the threads and waited for at a block barrier); 128-query tiles with two
// consumer warpgroups replace 64-query tiles of 4 warps; and V is read by
// wgmma's transposing descriptor instead of as 16-bit pairs. Left for later:
// the overlap at d = 128 (it needs registers), a persistent grid, and fp8. A
// 3-stage ring gave nothing at d = 80 or 128.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;                   // query rows per block
constexpr int BK = 128;                   // keys per K/V tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int BOX_COLS = 64;              // bf16 columns of a wide box: the 128-byte swizzle span
constexpr int BOX_BYTES = 128 * BOX_COLS * 2;  // one 128-row wide box (16 KB)
constexpr int NARROW_COLS = 16;           // bf16 columns of a narrow box: the 32-byte swizzle span
constexpr int NARROW_BYTES = 128 * NARROW_COLS * 2;  // one 128-row narrow box (4 KB)
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-aligned base (the swizzle atom)
template <int D>
struct Smem {
  static_assert(D == 64 || D == 80 || D == 128, "the wgmma design takes d = 64, 80 or 128");
  static constexpr int NB = D / BOX_COLS;                   // wide boxes per 128-row tile
  static constexpr bool NARROW = D % BOX_COLS != 0;         // + one narrow box (d = 80)
  static constexpr int TILE = NB * BOX_BYTES + (NARROW ? NARROW_BYTES : 0);  // Q, K or V
  // a tile's P V overlaps the next tile's softmax where S, O and P fit the
  // registers together (at d = 128 ptxas serializes the wgmmas, C7512)
  static constexpr bool OVERLAP = D <= 80;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + STAGES * TILE;
  // q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int ALLOC = BAR + 8 * (1 + 4 * STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// until the phase of the given parity has completed. Every wait here is for
// a load or for a sibling warpgroup of the same block, microseconds; one that
// lasts WAIT_LIMIT_NS is a fault of the pipeline, and the kernel traps (the
// launch then reports an error) instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// ---- TMA --------------------------------------------------------------------

// box at coordinates (c0, c1, c2, c3) of a 4-D map into shared memory at dst;
// completion (its bytes) is reported to bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1); the
// offsets are in bytes. K-major: sbo = stride between 8-row groups, lbo
// unused. MN-major: lbo = stride between 64-element chunks along M/N, sbo =
// stride between 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the same with the 32-byte swizzle (layout type 3): rows of 32 bytes, the
// pattern repeating every 8 rows (256 bytes). K-major: sbo = 256, lbo
// unused. MN-major: sbo = 256 between 8-row groups along K, lbo = stride
// between 16-element chunks along N.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins an accumulator register in program order against the wgmma
// fence/commit/wait (the compiler does not see that wgmma writes it late)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// keeps a register A operand live until its product is waited for
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (+)= A B^T over 16 of the reduction dim: m64n128k16, A and B from shared
// memory, both K-major; scale_d == 0 overwrites the accumulator
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V over 16 keys: m64n64k16 into d[0..31], P from registers (bf16
// pairs in the accumulator layout), V from shared memory MN-major
// (imm-trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[N], const uint32_t (&a)[4],
                                             uint64_t db) {
  static_assert(N >= 32, "m64n64 writes 32 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over 16 keys: m64n16k16 into d[32..39] (columns 64..79 of a
// d = 80 accumulator), P from registers, V from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n16_at32(float (&d)[40], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over 16 keys: m64n128k16, P from registers (bf16 pairs in the
// accumulator layout), V from shared memory MN-major (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over keys 16kk.. of the V tile at v_tile: MN-major, so keys
// 16kk.. start 16 rows further (2048 bytes in a wide box, 512 in the narrow
// one); a second wide box is 16 KB further, the narrow box follows the wide
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint32_t v_tile, int kk) {
  const uint64_t wide = desc_sw128(v_tile + kk * 2048, BOX_BYTES, 1024);
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, wide);
  } else {
    wgmma_rs_n64(o, a, wide);
    if constexpr (D == 80)
      wgmma_rs_n16_at32(o, a, desc_sw32(v_tile + BOX_BYTES + kk * 512, NARROW_BYTES, 256));
  }
}

// named barriers 1 and 2 take the two consumer warpgroups' products in turns
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ---- softmax helpers --------------------------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq_narrow,
                   const __grid_constant__ CUtensorMap tk_narrow,
                   const __grid_constant__ CUtensorMap tv_narrow, bf16* __restrict__ o,
                   int t_len, int hq, int hkv, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q, sk = base + L::K, sv = base + L::V;
  const uint32_t q_full = base + L::BAR;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows first
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int n_all = (t_len + BK - 1) / BK;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;  // BQ == BK

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      // one 128-row tile: its wide boxes, then the narrow one; the barrier
      // expects the bytes of all of them
      auto load_tile = [&](uint32_t dst, const CUtensorMap* wide, const CUtensorMap* narrow,
                           uint32_t bar, int head, int row) {
        mbar_expect_tx(bar, L::TILE);
#pragma unroll
        for (int c = 0; c < L::NB; ++c)
          tma_load_4d(dst + c * BOX_BYTES, wide, bar, c * BOX_COLS, head, row, b);
        if constexpr (L::NARROW)
          tma_load_4d(dst + L::NB * BOX_BYTES, narrow, bar, L::NB * BOX_COLS, head, row, b);
      };
      load_tile(sq, &tq, &tq_narrow, q_full, h, q0);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(k_empty(s), ph ^ 1);  // the first round finds every stage free
        load_tile(sk + s * L::TILE, &tk, &tk_narrow, k_full(s), hk, kt * BK);
        mbar_wait(v_empty(s), ph ^ 1);
        load_tile(sv + s * L::TILE, &tv, &tv_narrow, v_full(s), hk, kt * BK);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int t4 = lane % 4;
    const int row0 = q0 + wg * 64 + (tid / 32) * 16 + lane / 4;  // and row0 + 8
    const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's rows of each wide Q box
    const uint32_t qn = sq + L::NB * BOX_BYTES + wg * 64 * 32;  // ... of the narrow Q box

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, scaled to the exp2 domain
    float lp[2] = {0.f, 0.f};             // this thread's share of the running sum
    float corr[2];                        // O's rescale before the next P V
    // S = Q K^T: sc[4j + e] is (row0 + 8 (e >> 1), key k0 + 8j + 2 t4 + (e & 1))
    float sc[64];
    // P of a tile as the register A operand of its P V: its fragment for
    // keys 16kk.. is the S accumulator's columns 16kk.. (j = 2kk, 2kk + 1)
    uint32_t pa[BK / 16][4];

    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < 4 * L::NB; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(qa + off, 16, 1024),
                      desc_sw128(sk + s * L::TILE + off, 16, 1024), kk > 0);
      }
      if constexpr (L::NARROW)  // d 64..79: one k16 step, rows of 32 bytes
        wgmma_ss_n128(sc, desc_sw32(qn, 16, 256),
                      desc_sw32(sk + s * L::TILE + L::NB * BOX_BYTES, 16, 256), 1);
      wg_commit();
    };
    // O += P V: V [keys, d] is MN-major for this product
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv<D>(acc, pa[kk], sv + s * L::TILE, kk);
      wg_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    };
    // online softmax of tile kt's S per row, over the quad of lanes that
    // shares it; leaves P in sc and O's rescale in corr
    auto softmax = [&](int kt) {
      if (kt == n_tiles - 1) {  // mask keys past T, and after the query when causal
        const int k0 = kt * BK;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          const int q = row0 + 8 * ((i >> 1) & 1);
          if (key >= t_len || (causal && key > q)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
        base[r] = mnew == -INFINITY ? 0.f : mnew;  // every key masked so far
        corr[r] = fast_exp2(m[r] - base[r]);
        m[r] = mnew;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -base[r]));
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) lp[r] = lp[r] * corr[r] + rs[r];
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    };

    mbar_wait(q_full, 0);
    if constexpr (L::OVERLAP) {
      // tile kt's S and tile kt - 1's P V are issued back to back, and tile
      // kt's softmax runs while the tensor cores finish that P V; the two
      // warpgroups issue their products in turns (named barriers 1 + wg),
      // so one's softmax also overlaps the other's products
      if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
      mbar_wait(k_full(0), 0);
      named_sync(1 + wg);
      wg_fence();
      issue_s(0);
      named_arrive(2 - wg);
      wg_wait<0>();
      reg_fence(sc);
      mbar_arrive(k_empty(0));
      softmax(0);
      pack();
      for (int kt = 1; kt < n_tiles; ++kt) {
        const int s = kt % STAGES, sp = (kt - 1) % STAGES;
        rescale();
        mbar_wait(k_full(s), (kt / STAGES) & 1);
        mbar_wait(v_full(sp), ((kt - 1) / STAGES) & 1);
        reg_fence(acc);
        named_sync(1 + wg);
        wg_fence();
        issue_s(s);
        issue_pv(sp);
        named_arrive(2 - wg);
        wg_wait<1>();  // S is in
        reg_fence(sc);
        mbar_arrive(k_empty(s));
        softmax(kt);
        wg_wait<0>();  // P V is in: acc and pa are free
        reg_fence(acc);
        reg_fence(pa);
        mbar_arrive(v_empty(sp));
        pack();
      }
      const int sl = (n_tiles - 1) % STAGES;  // the last tile's P V
      rescale();
      mbar_wait(v_full(sl), ((n_tiles - 1) / STAGES) & 1);
      reg_fence(acc);
      named_sync(1 + wg);
      wg_fence();
      issue_pv(sl);
      if (wg == 0) named_arrive(2);  // warpgroup 1's last turn needs no successor
      wg_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
    } else {
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        const uint32_t ph = (kt / STAGES) & 1;
        mbar_wait(k_full(s), ph);
        wg_fence();
        issue_s(s);
        wg_wait<0>();
        reg_fence(sc);
        mbar_arrive(k_empty(s));
        softmax(kt);
        rescale();
        pack();
        mbar_wait(v_full(s), ph);
        reg_fence(acc);
        wg_fence();
        issue_pv(s);
        wg_wait<0>();
        reg_fence(acc);
        mbar_arrive(v_empty(s));
      }
    }

    // normalise and write bf16 pairs; rows past T are not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const float l = quad_sum(lp[r]);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      if (row < t_len) {
        bf16* orow = o + ((static_cast<size_t>(b) * t_len + row) * hq + h) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                           12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// 4-D map over a contiguous [B, T, H, d] bf16 tensor, innermost first: boxes
// of `cols` columns x 1 head x 128 rows x 1 batch, zeros out of bounds; wide
// boxes (64 columns) take the 128-byte swizzle, narrow ones (16) the 32-byte
// one. Returns 0, or a nonzero code.
int make_map(CUtensorMap* map, const void* ptr, int d, int heads, int t_len, int batch,
             int cols) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t_len,
                              (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)d * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * t_len};  // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == NARROW_COLS ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 20000 + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int t_len,
           int hq, int hkv, int causal, cudaStream_t stream) {
  // the wide maps, and the narrow ones where the tile has a narrow box
  // (elsewhere the kernel never reads them: copies of the wide ones)
  CUtensorMap mq, mk, mv;
  int e = make_map(&mq, q, D, hq, t_len, batch, BOX_COLS);
  if (e == 0) e = make_map(&mk, k, D, hkv, t_len, batch, BOX_COLS);
  if (e == 0) e = make_map(&mv, v, D, hkv, t_len, batch, BOX_COLS);
  CUtensorMap nq = mq, nk = mk, nv = mv;
  if constexpr (Smem<D>::NARROW) {
    if (e == 0) e = make_map(&nq, q, D, hq, t_len, batch, NARROW_COLS);
    if (e == 0) e = make_map(&nk, k, D, hkv, t_len, batch, NARROW_COLS);
    if (e == 0) e = make_map(&nv, v, D, hkv, t_len, batch, NARROW_COLS);
  }
  if (e != 0) return e;
  auto kern = flash_wgmma_kernel<D>;
  const cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(hq, (t_len + BQ - 1) / BQ, batch);
  kern<<<grid, THREADS, Smem<D>::ALLOC, stream>>>(mq, mk, mv, nq, nk, nv, static_cast<bf16*>(o),
                                                  t_len, hq, hkv, causal,
                                                  LOG2E / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, o [B, T, Hq, d] and k, v [B, T, Hkv, d], contiguous and 16-byte
// aligned; d = 64, 80 or 128. Returns cudaGetLastError() after the launch, or
// 20000 + the CUresult of a failed tensor-map encoding.
extern "C" int ejfat_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* o, int batch, int t_len, int hq, int hkv,
                                           int d, int causal, void* stream) {
  if (batch <= 0 || t_len <= 0 || hkv <= 0 || hq % hkv != 0 || batch > 65535 ||
      (t_len + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
  if (d == 80) return launch<80>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
  if (d == 128) return launch<128>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
  return (int)cudaErrorInvalidValue;
}
