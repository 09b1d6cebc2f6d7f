// Attention forward with an online softmax (flash attention) for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention. Same function: o = softmax(q k^T / sqrt(d) [+ causal
// mask]) v per (batch, query head), logits, running max m, running sum l and
// the accumulator in fp32, a row with l == 0 gives 0, output in the input
// dtype. Two differences from the Pallas kernel, both in what it computes
// and not in how:
//   * GQA is read in place: query head h reads KV head h / (Hq / Hkv), which
//     is the Pallas kernel applied to KV heads repeated (as its docstring asks
//     GQA callers to do) without materialising the repeat.
//   * Key positions >= T are masked whether causal or not. The Pallas kernel
//     pads K/V with zero rows and masks only when causal, so its non-causal
//     output at a T that is not a multiple of the block lets the padded keys
//     (score 0) into the softmax; kernels/ref.flash_attention_ref, the
//     oracle of both, does not.
//
// Layout: q, o [B, T, Hq, d] and k, v [B, T, Hkv, d], contiguous; fp32 at
// d in {16, 32, 64, 80, 128}, bf16 at d in {16, 32} (bf16 at d = 64, 80
// and 128 runs the wgmma design of flash_attention_wgmma.cu). Grid
// (ceil(T/64), Hq, B): one block of four warps per (query tile of 64 rows,
// head, batch); each warp owns 16
// query rows. K/V tiles of 64 rows are staged in shared memory (rows padded
// by 16 bytes so the fragment reads are free of bank conflicts); a causal
// block stops its K loop at the tile of its own last query.
//
// Bound: at a long prefill (B=1, T=4096, Hq=32, Hkv=4, bf16, causal; d=128
// there, so served by the wgmma design) the two products are
// 4 Hq d T(T+1)/2 = 137.5 GFLOP against 75.5 MB of q, k, v and o, so
// attention is bound by tensor-core operations (0.139 ms at 989 TFLOP/s vs
// 0.023 ms at 3.35 TB/s). bf16 runs both products on the tensor cores with
// mma.sync m16n8k16 (fp32 accumulate); P goes from the S accumulator to the
// A operand of P V in registers, never through shared memory. fp32 (kept
// for exact checks at small shapes) does the products with FMAs.
//
// What this simple design gives up, and flash_attention_wgmma.cu has: wgmma
// (the only path to the full Hopper tensor-core rate; mma.sync reaches a
// fraction of it), TMA and a multi-stage shared-memory ring (here every tile
// is loaded by the threads and waited for before any product starts, so
// loads and products never overlap), warp specialisation, and a transposing
// read of the V operand (here as 16-bit pairs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// row padding of a staged tile: 16 bytes
template <typename T>
__host__ __device__ constexpr int pad_of() { return 16 / (int)sizeof(T); }

template <typename T, int D>
__host__ __device__ constexpr int ld_of() { return D + pad_of<T>(); }

template <typename T, int D>
constexpr size_t smem_bytes() {
  // bf16: K and V tiles (Q is staged through the K tile once);
  // fp32: K, V and Q tiles plus each warp's 16 x BK probabilities
  return std::is_same<T, bf16>::value
             ? (size_t)2 * BK * ld_of<T, D>() * sizeof(T)
             : (size_t)(2 * BK + BQ) * ld_of<T, D>() * sizeof(T) +
                   (size_t)WARPS * 16 * BK * sizeof(float);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + 64) of a [T, row_stride] matrix (d contiguous) into a
// padded shared tile, 16 bytes per thread and load; rows >= T become zeros
// (a zero V row times p = 0 stays 0, where stale bits could be NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* sm, const T* g, int row0, int t_len,
                                          size_t row_stride) {
  constexpr int LD = ld_of<T, D>();
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    int4 v = make_int4(0, 0, 0, 0);
    if (row0 + r < t_len)
      v = *reinterpret_cast<const int4*>(g + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(sm + r * LD + c) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_len, int hq,
                 int hkv, int causal, float scale_log2) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int LD = ld_of<T, D>();
  constexpr int NS = BK / 8;  // S fragments per warp row block (8 keys each)
  constexpr int NO = D / 8;   // O fragments (8 columns each)
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * LD;
  T* qs = vs + BK * LD;                                  // fp32 only
  float* ps = reinterpret_cast<float*>(qs + BQ * LD);    // fp32 only

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_rs = (size_t)hq * D, k_rs = (size_t)hkv * D;
  const T* qb = q + (size_t)b * t_len * q_rs + (size_t)h * D;
  const T* kb = k + (size_t)b * t_len * k_rs + (size_t)hk * D;
  const T* vb = v + (size_t)b * t_len * k_rs + (size_t)hk * D;
  T* ob = o + (size_t)b * t_len * q_rs + (size_t)h * D;

  const int q0 = qt * BQ;
  const int row = warp * 16 + g;  // this thread's rows of the tile: row, row + 8
  const int qpos[2] = {q0 + row, q0 + row + 8};

  // Q as mma A fragments (bf16), staged through the K tile; fp32 keeps it
  // in its own tile, made visible by the first barrier of the K loop
  uint32_t qf[BF16 ? D / 16 : 1][4];
  if constexpr (BF16) {
    load_tile<T, D>(ks, qb, q0, t_len, q_rs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* base = ks + row * LD + kk * 16 + t4 * 2;
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
    }
    __syncthreads();
  } else {
    load_tile<T, D>(qs, qb, q0, t_len, q_rs);
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_all = (t_len + BK - 1) / BK;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;  // BQ == BK

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, D>(ks, kb, k0, t_len, k_rs);
    load_tile<T, D>(vs, vb, k0, t_len, k_rs);
    __syncthreads();

    // S = Q K^T: s[n][j] is (row, key k0 + 8n + 2 t4 + j), s[n][2 + j] row + 8
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = ks + (n * 8 + g) * LD + kk * 16 + t4 * 2;
          mma_16816(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    } else {
      const float* qa = reinterpret_cast<const float*>(qs) + row * LD;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* kr = reinterpret_cast<const float*>(ks) + (n * 8 + t4 * 2 + j) * LD;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) {
            s0 = fmaf(qa[d], kr[d], s0);
            s1 = fmaf(qa[8 * LD + d], kr[d], s1);
          }
          s[n][j] = s0;
          s[n][2 + j] = s1;
        }
      }
    }

    // mask (keys past T always; keys after the query when causal), scale
    // into the exp2 domain, online softmax per row over the quad of lanes
    // that shares it
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const bool ok = key < t_len && (!causal || key <= qpos[r]);
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    }
    float base[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // all masked so far
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_f2(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_f2(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const T* vr = vs + (kk * 16 + t4 * 2) * LD + n * 8 + g;
          mma_16816(acc[n], a, pack_h2(vr[0], vr[LD]),
                    pack_h2(vr[8 * LD], vr[9 * LD]));
        }
      }
    } else {
      float* p = ps + warp * 16 * BK;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[(g + 8 * (e >> 1)) * BK + n * 8 + t4 * 2 + (e & 1)] = s[n][e];
      }
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs);
      for (int key = 0; key < BK; ++key) {
        const float p0 = p[g * BK + key], p1 = p[(g + 8) * BK + key];
        const float* vr = vf + key * LD + t4 * 2;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] = fmaf(p0, vr[n * 8], acc[n][0]);
          acc[n][1] = fmaf(p0, vr[n * 8 + 1], acc[n][1]);
          acc[n][2] = fmaf(p1, vr[n * 8], acc[n][2]);
          acc[n][3] = fmaf(p1, vr[n * 8 + 1], acc[n][3]);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this K/V tile
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= t_len) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* orow = ob + (size_t)qpos[r] * q_rs + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
      if constexpr (BF16)
        *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_f2(x0, x1);
      else
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(x0, x1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int t_len, int hq, int hkv, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((t_len + BQ - 1) / BQ, hq, batch);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t_len, hq, hkv, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int batch,
               int t_len, int hq, int hkv, int d, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
    default: break;
  }
  if constexpr (!std::is_same<T, bf16>::value) {  // bf16 runs the wgmma design there
    if (d == 64) return launch<T, 64>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
    if (d == 80) return launch<T, 80>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
    if (d == 128) return launch<T, 128>(q, k, v, o, batch, t_len, hq, hkv, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int ejfat_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int batch, int t_len, int hq, int hkv,
                                     int d, int dtype, int causal, void* stream) {
  if (batch <= 0 || t_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, batch, t_len, hq, hkv, d, causal, s);
  if (dtype == 1) return dispatch_d<bf16>(q, k, v, o, batch, t_len, hq, hkv, d, causal, s);
  return (int)cudaErrorInvalidValue;
}
