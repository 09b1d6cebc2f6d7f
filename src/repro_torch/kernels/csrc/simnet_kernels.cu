// Device helpers of the virtual-time simulator (repro_torch/simnet) for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
// Each entry point takes raw device pointers, sizes and the CUDA stream,
// launches on that stream, does not synchronise, allocates nothing, and
// returns the first CUDA error of its calls.
//
// None replaces a Pallas kernel: each is a sequential scan that the JAX
// package writes as lax.scan / lax.fori_loop / cumsum, and that the port's
// fused engine would otherwise run as thousands of tiny launches per window
// or, for the running sum, in another order of additions.
//
// Float64 exactness: every operation is the reference's own, in its order,
// written with the _rn intrinsics, which nvcc never contracts into an FMA.
//
// farm_serve and seq_cumsum are each bound by one chain of dependent float64
// operations that no parallel order may shorten (the result must equal the
// host's bit for bit). Both share one shape: a single walker thread runs the
// chain on operands it has already pulled from shared memory into registers,
// while a copy warp streams tiles through a ring in shared memory with
// cp.async (in) and coalesced stores (out), handing each tile over with
// mbarriers per stage; in farm_serve that warp also does every part of a
// row that is not on the chain. ejfat_chain_probe times the chains alone, in
// one thread with every operand in a register, so that the chain bounds are
// measured on the card and not assumed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The ring's hand-over: mbarriers and 8-byte cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// release: this thread's shared-memory writes before it are seen by a waiter
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
// a copy of a few kB or for the sibling role of the same block,
// microseconds; one that lasts WAIT_LIMIT_NS is a fault of the ring, and the
// kernel traps (the launch then reports an error) instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// 8 bytes from device memory into shared memory, asynchronously. 8 bytes, so
// a member's rows need no 16-byte alignment: its first row may sit anywhere.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// one arrival on bar once every cp.async this thread issued so far has
// landed; the arrival is counted in bar's init count (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

constexpr int kRingThreads = 64;  // warp 0: the walker (lane 0); warp 1: copies

// ---------------------------------------------------------------------------
// farm_serve — the bounded Lindley recursion of the farm queues
// (repro/simnet/queues.py::_serve_jnp and the fused step's lax.scan at
// repro/simnet/fused.py:276-288; the numpy engine _serve_np is the op order).
//
// Rows come sorted by (member, arrival, row) with member m's rows at
// [offsets[m], offsets[m+1]). Each member's rows are walked in order:
//
//   t  = max(t_row, t_last)        (server time never rewinds)
//   w  = max(w - (t - t_last), 0)  (the server drains in real time)
//   drop = w + s > cap             (drop-tail on work-seconds)
//   dep  = (t + w) + s, w = w + s  (accepted rows only)
//   w_max = max(w_max, w), t_last = t
//
// Bound: the chain carried on w from row to row, times the longest member's
// rows. Per row the kernel moves 25 bytes (t, s in; dep, drop out), nothing
// against the card's memory rate. In the reference's order the chain is
// sub, max, add, compare, select, and on this card a float64 max or compare
// is a DSETP whose predicate reaches its select some 35-40 cycles later
// (95 cycles a row in the chain probe). So everything but that chain leaves
// the walking thread:
//
//   - t_last is a running max, exact in any order: before the walk, the copy
//     warp computes each row's t (a prefix max over the tile, the previous
//     tile's last t carried in) and dt = t - t_prev, its lanes in parallel;
//   - the walker carries both candidate backlogs (keep: before the row's
//     service, take: after it) and the drop bit, and picks after the
//     subtraction: max(w - dt, 0) = drop ? relu(keep - dt) : relu(take - dt),
//     where relu clears a negative double with integer operations (as
//     numpy's np.maximum(x, 0.0) does, -0.0 gives +0.0). The chain becomes
//     sub, relu, add, compare, and the compare's predicate picks between
//     two values already computed instead of starting a sub and a max;
//   - dep = (t + w) + s and the peak backlog (a max, exact in any order) come
//     after the walk from the walker's w and drop bits, in parallel.
//
// Each value is the reference's bit for bit for inputs without NaN (a max
// taken in another order may pick another NaN) and a carried backlog that
// is not -0.0 (no run produces one; there relu gives numpy's +0.0 where
// torch.maximum keeps -0.0).
//
// ejfat_chain_probe times the walker's row (farm_walk) and the reference's
// order (farm_row_straight), every operand in a register.
//
// Design: one block per member, so the members' chains run on as many SMs.
// Warp 1 streams the member's t and s through a ring of kFarmStages tiles of
// kFarmTile rows with cp.async (8 bytes a lane, coalesced), prepares each
// tile (t, dt) one tile ahead of the walker, and after the walk computes
// dep, drop and the peak and writes them back coalesced. Lane 0 of warp 0
// walks: it reads the next kFarmBatch rows' dt and s from shared memory
// (16-byte loads) before the current rows' chains, and writes w over dt and
// the drop bits (8 rows a 64-bit store). Per stage, mbarriers full (the
// copies landed), ready (prepared, to the walker) and done (walked, back to
// warp 1) hand the tile over.
// ---------------------------------------------------------------------------

constexpr int kFarmTile = 256;  // 32 lanes x 8 consecutive rows in the preparation
constexpr int kFarmStages = 4;  // 4 x 256 x 25 B = 25 KB of static shared memory
constexpr int kFarmBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

// One row in the reference's order: updates (w, t_last, w_max), returns the
// drop bit and the completion time (inf when dropped). Only the chain probe
// runs it, as the yardstick of farm_walk.
__device__ __forceinline__ bool farm_row_straight(double tr, double sr, double c, double& w,
                                                  double& t_last, double& w_max,
                                                  double& dep) {
  const double tt = fmax(tr, t_last);
  w = fmax(__dsub_rn(w, __dsub_rn(tt, t_last)), 0.0);
  const double ws = __dadd_rn(w, sr);
  const bool d = ws > c;
  dep = d ? INFINITY : __dadd_rn(__dadd_rn(tt, w), sr);
  if (!d) w = ws;
  w_max = fmax(w_max, w);
  t_last = tt;
  return d;
}

// max(x, 0.0) by clearing a negative double's bits (-0.0 -> +0.0, as numpy)
__device__ __forceinline__ double relu(double x) {
  const long long b = __double_as_longlong(x);
  return __longlong_as_double(b & ~(b >> 63));
}

// The walker's carry: the backlog after the last row is `drop ? keep : take`.
struct FarmWalk {
  double keep, take;
  bool drop;
};

// one row of the walk: w is the row's backlog before its service
// (max(w_prev - dt, 0)); returns the drop bit
__device__ __forceinline__ bool farm_walk(double dt, double sr, double c, FarmWalk& q,
                                          double& w) {
  double a = relu(__dsub_rn(q.keep, dt));
  double b = relu(__dsub_rn(q.take, dt));
  // opaque to the optimizer, which would otherwise fold the select back in
  // front of the sub and the relu (select(p, f(x), f(y)) -> f(select(p, x, y)))
  asm("" : "+d"(a), "+d"(b));
  w = q.drop ? a : b;
  const double ws = __dadd_rn(w, sr);
  q.drop = ws > c;
  q.keep = w;
  q.take = ws;
  return q.drop;
}

__global__ void __launch_bounds__(kRingThreads)
    farm_serve_kernel(const double* __restrict__ t, const double* __restrict__ s,
                      const int32_t* __restrict__ offsets, const double* __restrict__ w0,
                      const double* __restrict__ t0, const double* __restrict__ cap,
                      double* __restrict__ dep, uint8_t* __restrict__ drop,
                      double* __restrict__ w_out, double* __restrict__ t_last_out,
                      double* __restrict__ w_max_out) {
  static_assert(kFarmTile == 32 * 8, "the preparation gives each lane 8 consecutive rows");
  __shared__ __align__(16) double ring_t[kFarmStages][kFarmTile];  // t in, the row's t out
  __shared__ __align__(16) double ring_s[kFarmStages][kFarmTile];
  __shared__ __align__(16) double ring_x[kFarmStages][kFarmTile];  // dt in, w out
  __shared__ __align__(8) uint8_t ring_d[kFarmStages][kFarmTile];
  __shared__ __align__(8) uint64_t full[kFarmStages], ready[kFarmStages], done[kFarmStages];
  const int m = blockIdx.x;
  const int lo = offsets[m], rows = max(offsets[m + 1] - lo, 0);
  const int n_tiles = (rows + kFarmTile - 1) / kFarmTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kFarmStages; ++st) {
      mbar_init(smem_u32(&full[st]), 32);
      mbar_init(smem_u32(&ready[st]), 32);
      mbar_init(smem_u32(&done[st]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // ---- warp 1: copies, preparation, completion ----
    const int lane = threadIdx.x - 32;
    auto load = [&](int k) {
      const int st = k % kFarmStages, base = k * kFarmTile;
      const int len = min(kFarmTile, rows - base);
      for (int i = lane; i < len; i += 32) {
        cp_async8(smem_u32(&ring_t[st][i]), t + lo + base + i);
        cp_async8(smem_u32(&ring_s[st][i]), s + lo + base + i);
      }
      cp_async_arrive(smem_u32(&full[st]));
    };
    // each row's t and dt: a prefix max over the tile's rows (rows past the
    // tile's end count as -inf), each lane over its 8 rows, then across the
    // lanes, with the t of the row before the tile (t_prev) carried in
    double t_prev = t0[m];
    auto prepare = [&](int k) {
      const int st = k % kFarmStages, r0 = lane * 8;
      const int len = min(kFarmTile, rows - k * kFarmTile);
      mbar_wait(smem_u32(&full[st]), (k / kFarmStages) & 1);
      double v[8];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const double2 p = *reinterpret_cast<const double2*>(&ring_t[st][r0 + j]);
        v[j] = r0 + j < len ? p.x : -INFINITY;
        v[j + 1] = r0 + j + 1 < len ? p.y : -INFINITY;
      }
#pragma unroll
      for (int j = 1; j < 8; ++j) v[j] = fmax(v[j], v[j - 1]);
      double upto = v[7];  // max over lanes 0..lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, upto, o);
        if (lane >= o) upto = fmax(upto, u);
      }
      const double below = __shfl_up_sync(kFull, upto, 1);
      double prev = lane == 0 ? t_prev : fmax(below, t_prev);  // t of row r0 - 1
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const double ta = fmax(v[j], prev), tb = fmax(v[j + 1], prev);
        const double2 dt = make_double2(__dsub_rn(ta, prev), __dsub_rn(tb, ta));
        *reinterpret_cast<double2*>(&ring_t[st][r0 + j]) = make_double2(ta, tb);
        *reinterpret_cast<double2*>(&ring_x[st][r0 + j]) = dt;
        prev = tb;
      }
      t_prev = fmax(t_prev, __shfl_sync(kFull, upto, 31));
      mbar_arrive(smem_u32(&ready[st]));
    };
    double w_max = w0[m];
    for (int k = 0; k < min(kFarmStages, n_tiles); ++k) load(k);
    if (n_tiles > 0) prepare(0);
    for (int k = 0; k < n_tiles; ++k) {
      if (k + 1 < n_tiles) prepare(k + 1);
      const int st = k % kFarmStages, base = k * kFarmTile;
      const int len = min(kFarmTile, rows - base);
      mbar_wait(smem_u32(&done[st]), (k / kFarmStages) & 1);
      for (int i = lane; i < len; i += 32) {
        const double tr = ring_t[st][i], w = ring_x[st][i], sr = ring_s[st][i];
        const bool d = ring_d[st][i] != 0;
        dep[lo + base + i] = d ? INFINITY : __dadd_rn(__dadd_rn(tr, w), sr);
        drop[lo + base + i] = d ? 1 : 0;
        w_max = fmax(w_max, d ? w : __dadd_rn(w, sr));
      }
      __syncwarp();  // every lane's reads of the slot before any lane refills it
      if (k + kFarmStages < n_tiles) load(k + kFarmStages);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w_max = fmax(w_max, __shfl_xor_sync(kFull, w_max, o));
    if (lane == 0) {
      t_last_out[m] = t_prev;
      w_max_out[m] = w_max;
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // ---- the walker ----------------------------------------------------------
  const double c = cap[m];
  FarmWalk q{w0[m], w0[m], true};
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kFarmStages;
    const int len = min(kFarmTile, rows - k * kFarmTile);
    mbar_wait(smem_u32(&ready[st]), (k / kFarmStages) & 1);
    double* tile_x = ring_x[st];
    const double* tile_s = ring_s[st];
    uint8_t* tile_d = ring_d[st];
    const int nb = len / kFarmBatch;
    double2 cx[kFarmBatch / 2], cs[kFarmBatch / 2];
    if (nb > 0) {
#pragma unroll
      for (int j = 0; j < kFarmBatch / 2; ++j) {
        cx[j] = reinterpret_cast<const double2*>(tile_x)[j];
        cs[j] = reinterpret_cast<const double2*>(tile_s)[j];
      }
    }
    for (int b = 0; b < nb; ++b) {
      // the next batch's operands (this batch's again at the last one)
      const int nx = min(b + 1, nb - 1) * kFarmBatch;
      double2 nxt_x[kFarmBatch / 2], nxt_s[kFarmBatch / 2];
#pragma unroll
      for (int j = 0; j < kFarmBatch / 2; ++j) {
        nxt_x[j] = reinterpret_cast<const double2*>(tile_x + nx)[j];
        nxt_s[j] = reinterpret_cast<const double2*>(tile_s + nx)[j];
      }
      uint64_t bits = 0;
#pragma unroll
      for (int j = 0; j < kFarmBatch / 2; ++j) {
        double w0_, w1_;
        bits |= static_cast<uint64_t>(farm_walk(cx[j].x, cs[j].x, c, q, w0_)) << (16 * j);
        bits |= static_cast<uint64_t>(farm_walk(cx[j].y, cs[j].y, c, q, w1_)) << (16 * j + 8);
        reinterpret_cast<double2*>(tile_x + b * kFarmBatch)[j] = make_double2(w0_, w1_);
      }
      *reinterpret_cast<uint64_t*>(tile_d + b * kFarmBatch) = bits;
#pragma unroll
      for (int j = 0; j < kFarmBatch / 2; ++j) {
        cx[j] = nxt_x[j];
        cs[j] = nxt_s[j];
      }
    }
    for (int r = nb * kFarmBatch; r < len; ++r) {  // the member's last rows
      double w;
      tile_d[r] = farm_walk(tile_x[r], tile_s[r], c, q, w) ? 1 : 0;
      tile_x[r] = w;
    }
    mbar_arrive(smem_u32(&done[st]));
  }
  w_out[m] = q.drop ? q.keep : q.take;
}

// ---------------------------------------------------------------------------
// seq_cumsum — the downlink FIFO's running sum in numpy's order
// (repro/simnet/fused.py:242 jnp.cumsum, which the host engine computes with
// np.cumsum in repro/simnet/links.py:76).
//
// Float addition does not associate, and the host's sequential sum feeds
// drop-tail comparisons downstream, so the fused step adds in row order to
// stay bit-equal (torch.cumsum on the card adds in a tree, and no parallel
// scan may be used). Bound: the chain of n dependent float64 adds, n times
// the add's latency as ejfat_chain_probe measures it; bytes (16 per row)
// do not matter.
//
// Design: one block. Warp 1 streams kScanTile-row tiles through a ring of
// kScanStages in shared memory with cp.async and writes each finished tile
// back coalesced. Thread 0 walks: it loads the next kScanBatch values
// (16-byte loads) before the current batch's adds, so the adds run back to
// back, and stores the sums over the values. The sum starts from -0.0, the
// identity of float64 addition (-0.0 + x == x bit for bit, also for
// x = -0.0), so out[0] = x[0] as np.cumsum has it.
// ---------------------------------------------------------------------------

constexpr int kScanTile = 1024;
constexpr int kScanStages = 4;  // 4 x 1024 x 8 B = 32 KB of static shared memory
constexpr int kScanBatch = 16;

__global__ void __launch_bounds__(kRingThreads)
    seq_cumsum_kernel(const double* __restrict__ x, int n, double* __restrict__ out) {
  __shared__ __align__(16) double ring[kScanStages][kScanTile];
  __shared__ __align__(8) uint64_t full[kScanStages], done[kScanStages];
  const int n_tiles = (n + kScanTile - 1) / kScanTile;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kScanStages; ++st) {
      mbar_init(smem_u32(&full[st]), 32);
      mbar_init(smem_u32(&done[st]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {  // ---- the copy warp -----------------------------
    const int lane = threadIdx.x - 32;
    auto load = [&](int k) {
      const int st = k % kScanStages, base = k * kScanTile;
      const int len = min(kScanTile, n - base);
      for (int i = lane; i < len; i += 32) cp_async8(smem_u32(&ring[st][i]), x + base + i);
      cp_async_arrive(smem_u32(&full[st]));
    };
    for (int k = 0; k < min(kScanStages, n_tiles); ++k) load(k);
    for (int k = 0; k < n_tiles; ++k) {
      const int st = k % kScanStages, base = k * kScanTile;
      const int len = min(kScanTile, n - base);
      mbar_wait(smem_u32(&done[st]), (k / kScanStages) & 1);
      for (int i = lane; i < len; i += 32) out[base + i] = ring[st][i];
      if (k + kScanStages < n_tiles) load(k + kScanStages);
    }
    return;
  }
  if (threadIdx.x != 0) return;

  // ---- the walker ----------------------------------------------------------
  double acc = -0.0;
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kScanStages;
    const int len = min(kScanTile, n - k * kScanTile);
    mbar_wait(smem_u32(&full[st]), (k / kScanStages) & 1);
    double* tile = ring[st];
    const int nb = len / kScanBatch;
    double2 cur[kScanBatch / 2];
    if (nb > 0) {
#pragma unroll
      for (int j = 0; j < kScanBatch / 2; ++j) cur[j] = reinterpret_cast<const double2*>(tile)[j];
    }
    for (int b = 0; b < nb; ++b) {
      const int nx = min(b + 1, nb - 1) * kScanBatch;
      double2 nxt[kScanBatch / 2];
#pragma unroll
      for (int j = 0; j < kScanBatch / 2; ++j)
        nxt[j] = reinterpret_cast<const double2*>(tile + nx)[j];
#pragma unroll
      for (int j = 0; j < kScanBatch / 2; ++j) {
        acc = __dadd_rn(acc, cur[j].x);
        cur[j].x = acc;
        acc = __dadd_rn(acc, cur[j].y);
        cur[j].y = acc;
      }
#pragma unroll
      for (int j = 0; j < kScanBatch / 2; ++j) {
        reinterpret_cast<double2*>(tile + b * kScanBatch)[j] = cur[j];
        cur[j] = nxt[j];
      }
    }
    for (int i = nb * kScanBatch; i < len; ++i) {  // the last values
      acc = __dadd_rn(acc, tile[i]);
      tile[i] = acc;
    }
    mbar_arrive(smem_u32(&done[st]));
  }
}

// ---------------------------------------------------------------------------
// chain_probe — the chains above alone, in one thread, every operand in a
// register: n dependent __dadd_rn; n farm rows in the reference's order
// (farm_row_straight, the arrival times advancing by an add beside the
// chain); n rows of the walk (farm_walk, the kernel's own code, on the same
// rows' dt). Completions, backlogs and drop bits are stored to shared memory
// as the kernel stores them. clock64 and %globaltimer around each give
// cycles and ns, so the chain bounds of farm_serve and seq_cumsum are
// measured, not assumed.
// out: {cycles, ns} of the adds, the straight rows, the walk; sink keeps the
// chains' results live (NaN in sink[0] when the straight rows and the walk
// end on different backlogs).
// ---------------------------------------------------------------------------

__global__ void chain_probe_kernel(double a, double b, int n, double* __restrict__ sink,
                                   long long* __restrict__ out) {
  __shared__ double probe_x[kFarmTile];
  __shared__ uint8_t probe_drop[kFarmTile];
  const double step = b, sr = 1.5 * b, cap = 64.0 * b;  // the backlog fills, then drops
  double acc = a;
  long long c0 = clock64();
  uint64_t g0 = global_ns();
#pragma unroll 16
  for (int i = 0; i < n; ++i) acc = __dadd_rn(acc, b);
  sink[0] = acc;
  out[0] = clock64() - c0;
  out[1] = static_cast<long long>(global_ns() - g0);

  double tr = 0.0, w = 0.0, t_last = 0.0, w_max = 0.0;
  c0 = clock64();
  g0 = global_ns();
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    tr = __dadd_rn(tr, step);
    double d;
    probe_drop[i % kFarmTile] = farm_row_straight(tr, sr, cap, w, t_last, w_max, d) ? 1 : 0;
    probe_x[i % kFarmTile] = d;
  }
  sink[1] = w;
  out[2] = clock64() - c0;
  out[3] = static_cast<long long>(global_ns() - g0);

  FarmWalk q{0.0, 0.0, true};
  tr = 0.0;
  c0 = clock64();
  g0 = global_ns();
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const double tn = __dadd_rn(tr, step);
    const double dt = __dsub_rn(tn, tr);  // the straight row's dt (arrivals increase)
    tr = tn;
    double wr;
    probe_drop[i % kFarmTile] = farm_walk(dt, sr, cap, q, wr) ? 1 : 0;
    probe_x[i % kFarmTile] = wr;
  }
  sink[2] = q.drop ? q.keep : q.take;
  out[4] = clock64() - c0;
  out[5] = static_cast<long long>(global_ns() - g0);
  if (sink[1] != sink[2]) sink[0] = NAN;
  sink[1] += w_max + t_last + probe_x[a > 0.0 ? 1 : 0] + probe_drop[b > 0.0 ? 2 : 3];
}

// ---------------------------------------------------------------------------
// build_calendar — the fused engine's calendar rebuild
// (repro/simnet/fused.py::_device_calendar, itself op for op with
// repro/core/calendar.py::build_calendar), in one warp: lane i owns member i.
//
//   total = numpy's pairwise sum of w (fused.py::_np_sum)
//   ideal = w / total * 512; counts = max(floor(ideal), 1)
//   m surplus steps: the first member with the largest count - ideal (of
//     those above 1) gives a slot back while the counts exceed 512
//   m deficit steps: members in stable order of decreasing remainder take a
//     slot while the counts fall short of 512
//   512 smooth weighted round-robin steps (first maximum of the credits)
//   512 steps of the quota-enforcing walk: a slot of a member above its
//     quota goes to the next member below its quota, ascending
//
// It reads the switch decision (do_sw) from device memory and returns at
// once when it is false, leaving out untouched: the fused window step stays
// one captured graph with no host read.
//
// Bound: the chain of 2 x 512 dependent warp steps (each a 5-step shuffle
// reduction); bytes (w in, 2 KB out) do not matter.
// ---------------------------------------------------------------------------

constexpr int kMaxCalMembers = 32;
constexpr int kMaxSlots = 512;

__device__ double np_sum(const double* x, int m) {
  if (m < 8) {
    double acc = x[0];
    for (int i = 1; i < m; ++i) acc = __dadd_rn(acc, x[i]);
    return acc;
  }
  double r[8];
  for (int j = 0; j < 8; ++j) r[j] = x[j];
  int i = 8;
  for (; i < m - (m % 8); i += 8)
    for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], x[i + j]);
  double acc = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                         __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
  for (; i < m; ++i) acc = __dadd_rn(acc, x[i]);
  return acc;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// index of the first maximum over the lanes (jnp.argmax / np.argmax)
__device__ __forceinline__ int warp_argmax(double v, int idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return idx;
}

__global__ void build_calendar_kernel(const double* __restrict__ w, int m,
                                      const bool* __restrict__ do_sw, int n_slots,
                                      int32_t* __restrict__ out) {
  if (!*do_sw) return;
  __shared__ int32_t cal[kMaxSlots];
  __shared__ int32_t def_ids[kMaxCalMembers];
  const int lane = threadIdx.x;
  const bool live = lane < m;
  const double slots = static_cast<double>(n_slots);

  // -- largest-remainder quotas --------------------------------------------
  const double total = np_sum(w, m);
  const double ideal = live ? __dmul_rn(__ddiv_rn(w[lane], total), slots) : 0.0;
  const double fl = floor(ideal);
  long long cnt = live ? static_cast<long long>(fl) : 0;
  if (live && cnt == 0) cnt = 1;  // every live member reachable
  const double rem = __dsub_rn(ideal, fl);

  for (int it = 0; it < m; ++it) {  // surplus: give back while above n_slots
    const long long sum = warp_sum(cnt);
    const double over =
        (live && cnt > 1) ? __dsub_rn(static_cast<double>(cnt), ideal) : -INFINITY;
    const int pick = warp_argmax(over, lane);
    if (sum > n_slots && lane == pick) cnt -= 1;
  }
  // stable rank of this member in decreasing remainder (argsort(-rem))
  int rank = 0;
  for (int j = 0; j < m; ++j) {
    const double rj = __shfl_sync(kFull, rem, j);
    if (live && (rj > rem || (rj == rem && j < lane))) ++rank;
  }
  for (int i = 0; i < m; ++i) {  // deficit: take a slot while below n_slots
    const long long sum = warp_sum(cnt);
    if (sum < n_slots && live && rank == i) cnt += 1;
  }

  // -- smooth weighted round-robin ------------------------------------------
  const double remaining = static_cast<double>(cnt);
  double credit = live ? 0.0 : -INFINITY;
  for (int sl = 0; sl < n_slots; ++sl) {
    if (live) credit = __dadd_rn(credit, remaining);
    const int pick = warp_argmax(credit, lane);
    if (lane == pick) credit = __dadd_rn(credit, -slots);
    if (lane == 0) cal[sl] = pick;
  }
  __syncwarp();

  // -- the quota-enforcing walk ---------------------------------------------
  long long have = 0;
  for (int sl = 0; sl < n_slots; ++sl) have += (cal[sl] == lane);
  const bool deficit = live && have < cnt;
  long long need = deficit ? cnt - have : 0;
  const unsigned def_mask = __ballot_sync(kFull, deficit);
  const int len_def = __popc(def_mask);
  if (live) def_ids[lane] = m;
  __syncwarp();
  if (deficit) def_ids[__popc(def_mask & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  int di = 0;
  for (int sl = 0; sl < n_slots; ++sl) {
    const int cs = cal[sl];
    const int d = min(max(def_ids[min(max(di, 0), m - 1)], 0), m - 1);
    const long long have_cs = __shfl_sync(kFull, have, cs);
    const long long cnt_cs = __shfl_sync(kFull, cnt, cs);
    const bool cond = have_cs > cnt_cs && di < len_def;
    if (cond) {
      if (lane == cs) have -= 1;
      if (lane == d) {
        have += 1;
        need -= 1;
      }
    }
    const long long need_d = __shfl_sync(kFull, need, d);
    if (cond && need_d == 0) di += 1;
    if (lane == 0) out[sl] = cond ? d : cs;
  }
}

}  // namespace

extern "C" {

// rows sorted by (member, arrival, row); offsets int32[n_members + 1]; rows
// at and past offsets[n_members] are not touched. One block per member.
int ejfat_farm_serve(const double* t, const double* s, const int32_t* offsets,
                     const double* w0, const double* t0, const double* cap, int n_members,
                     double* dep, uint8_t* drop, double* w_out, double* t_last_out,
                     double* w_max_out, cudaStream_t stream) {
  if (n_members > 0)
    farm_serve_kernel<<<n_members, kRingThreads, 0, stream>>>(
        t, s, offsets, w0, t0, cap, dep, drop, w_out, t_last_out, w_max_out);
  return static_cast<int>(cudaGetLastError());
}

int ejfat_seq_cumsum(const double* x, int n, double* out, cudaStream_t stream) {
  if (n > 0) seq_cumsum_kernel<<<1, kRingThreads, 0, stream>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}

// one thread; sink float64[3], out int64[6] (see chain_probe_kernel)
int ejfat_chain_probe(double a, double b, int n, double* sink, long long* out,
                      cudaStream_t stream) {
  chain_probe_kernel<<<1, 1, 0, stream>>>(a, b, n, sink, out);
  return static_cast<int>(cudaGetLastError());
}

// w float64[m], 1 <= m <= 32, all positive; n_slots <= 512; out int32[n_slots]
// is written only when *do_sw is true.
int ejfat_build_calendar(const double* w, int m, const bool* do_sw, int n_slots,
                         int32_t* out, cudaStream_t stream) {
  if (m < 1 || m > kMaxCalMembers || n_slots < 1 || n_slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  build_calendar_kernel<<<1, 32, 0, stream>>>(w, m, do_sw, n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
