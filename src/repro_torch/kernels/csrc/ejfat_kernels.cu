// EJ-FAT data-plane kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes). Each entry point takes raw device pointers,
// sizes and the CUDA stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
//
// Integer convention: a uint32 protocol word travels as an int32 tensor with
// the same bits and is read here as uint32_t; the u32 epoch-segment starts
// are int64 tensors holding the unsigned value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMagic = 0x4C42;
constexpr uint32_t kVersion = 1;
constexpr uint32_t kSlotMask = 0x1FF;  // 512-slot calendars

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// lb_route — replaces the Pallas kernel src/repro/kernels/lb_route.py
// (lb_route -> _parse, _route_kernel, _route_kernel_mi).
//
// Bound: bytes. Per packet it reads 16 B of header words (+4 B instance id
// when the tables are stacked) and writes 4 int32 outputs, 16 B: ~36 B per
// packet against a few integer compares, so the card's 3.35 TB/s memory
// rate is the limit (~11 us at 2^20 packets).
//
// Design: one thread per packet. The header row is one 16-byte load
// (row-major [N, 4]; no field-major transpose as on the TPU) and the four
// outputs are coalesced 4-byte stores. The tables (one instance: 24.8 KB at
// 512 members; four stacked: ~99 KB) are read through the read-only data
// cache (__ldg) rather than staged in shared memory: every block would
// otherwise copy the whole table set before routing its 256 packets, which
// at 2^20 packets is ~4096 x 25-99 KB of extra L2 traffic, while the tables
// a window actually touches (the live calendar rows, the live members) stay
// resident in the SM's L1 after the first misses. The same code serves both
// the single and the stacked tables (template on MULTI), so the 99 KB stack
// needs no dynamic shared memory opt-in. Rows, members and instance ids are
// clipped exactly as the Pallas kernel clips them, so an invalid packet never
// reads outside a table.
// ---------------------------------------------------------------------------
template <bool MULTI>
__global__ void lb_route_kernel(
    const int4* __restrict__ hdr, const int32_t* __restrict__ iid, int n,
    const long long* __restrict__ seg_hi, const long long* __restrict__ seg_lo,
    const int32_t* __restrict__ seg_row, const int32_t* __restrict__ cal,
    const int32_t* __restrict__ node, const int32_t* __restrict__ base,
    const int32_t* __restrict__ mask, const int32_t* __restrict__ mvalid,
    int n_inst, int n_seg, int n_rows, int n_slots, int n_members,
    int32_t* __restrict__ member_out, int32_t* __restrict__ node_out,
    int32_t* __restrict__ lane_out, int32_t* __restrict__ valid_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // Parsing stage (paper §III-A): field extract + magic/version check.
  const int4 w = __ldg(hdr + i);
  const uint32_t w0 = static_cast<uint32_t>(w.x);
  const uint32_t w1 = static_cast<uint32_t>(w.y);
  const uint32_t e_hi = static_cast<uint32_t>(w.z);
  const uint32_t e_lo = static_cast<uint32_t>(w.w);
  bool ok = ((w0 >> 16) & 0xFFFFu) == kMagic && ((w0 >> 8) & 0xFFu) == kVersion;
  const int entropy = static_cast<int>(w1 & 0xFFFFu);

  int inst = 0;
  if (MULTI) inst = clampi(__ldg(iid + i), 0, n_inst - 1);

  // Calendar Epoch Assignment: segment = (#starts <= event) - 1, u64 compare.
  const uint64_t ev = (static_cast<uint64_t>(e_hi) << 32) | e_lo;
  const long long* shi = seg_hi + static_cast<long long>(inst) * n_seg;
  const long long* slo = seg_lo + static_cast<long long>(inst) * n_seg;
  int cnt = 0;
  for (int s = 0; s < n_seg; ++s) {
    const uint64_t start =
        (static_cast<uint64_t>(static_cast<uint32_t>(__ldg(shi + s))) << 32) |
        static_cast<uint32_t>(__ldg(slo + s));
    cnt += ev >= start ? 1 : 0;
  }
  const int idx = clampi(cnt - 1, 0, n_seg - 1);
  const int row = __ldg(seg_row + inst * n_seg + idx);

  // Calendar to Member Map: slot = 9 LSBs of the event number.
  const int slot = static_cast<int>(e_lo & kSlotMask);
  const int r = clampi(row, 0, n_rows - 1);
  const int member =
      __ldg(cal + (static_cast<long long>(inst) * n_rows + r) * n_slots + slot);

  // Member Lookup and Rewrite.
  const int mb = inst * n_members + clampi(member, 0, n_members - 1);
  const int nd = __ldg(node + mb);
  const int lane = __ldg(base + mb) + (entropy & __ldg(mask + mb));
  ok = ok && row >= 0 && member >= 0 && __ldg(mvalid + mb) > 0;

  member_out[i] = ok ? member : -1;
  node_out[i] = ok ? nd : -1;
  lane_out[i] = ok ? lane : -1;
  valid_out[i] = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// dispatch_plan — replaces the Pallas kernel src/repro/kernels/dispatch.py
// (dispatch_plan -> _plan_kernel).
//
// pos_i = #{j < i : member_j == member_i} (stable), counts[m] = total per
// member; pos = -1 for member < 0; a member >= n_members gets pos 0 and is
// not counted (the Pallas one-hot over arange(M) is all zero there).
//
// Bound: bytes. 4 B read and 4 B written per packet (~2.5 us at 2^20), plus
// the per-tile histograms, which are n/4096 x M ints (512 KB at 2^20 and
// M = 512, L2-resident).
//
// Design: the TPU kernel walks its grid in order and carries an f32 [M]
// running count from one block to the next. CUDA blocks run in any order,
// so the running count becomes three launches with no carry between blocks:
//   1. dp_count: each block takes a tile of 4096 packets and builds its
//      per-member histogram with shared-memory atomics;
//   2. dp_scan: one thread per member scans the tile histograms into
//      exclusive per-tile offsets and writes counts[m];
//   3. dp_rank: each block walks its tile again in order, 256 packets at a
//      time: the in-warp rank is __match_any_sync + popc of the lower lanes,
//      the earlier warps of the chunk come from per-warp counts in shared
//      memory, and the earlier chunks and tiles from a running offset.
// Counts are int32 and exact (the Pallas f32 carry is exact only below 2^24
// per member).
// ---------------------------------------------------------------------------
constexpr int kDpThreads = 256;
constexpr int kDpWarps = kDpThreads / 32;
constexpr int kDpChunks = 16;
constexpr int kDpTile = kDpThreads * kDpChunks;

__global__ void dp_count(const int32_t* __restrict__ member, int n, int n_members,
                         int32_t* __restrict__ tile_counts) {
  extern __shared__ int32_t hist[];
  for (int m = threadIdx.x; m < n_members; m += blockDim.x) hist[m] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kDpTile;
  for (int k = threadIdx.x; k < kDpTile; k += blockDim.x) {
    const long long i = base + k;
    if (i < n) {
      const int m = __ldg(member + i);
      if (m >= 0 && m < n_members) atomicAdd(&hist[m], 1);
    }
  }
  __syncthreads();
  for (int m = threadIdx.x; m < n_members; m += blockDim.x)
    tile_counts[static_cast<long long>(blockIdx.x) * n_members + m] = hist[m];
}

__global__ void dp_scan(int32_t* __restrict__ tile_counts, int n_tiles, int n_members,
                        int32_t* __restrict__ counts) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_members) return;
  // A serial walk over the tiles: batches of kBatch independent loads keep
  // that many requests in flight instead of one L2 round trip per tile.
  constexpr int kBatch = 16;
  int run = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += kBatch) {
    int c[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      c[j] = b0 + j < n_tiles
                 ? tile_counts[static_cast<long long>(b0 + j) * n_members + m]
                 : 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (b0 + j < n_tiles)  // in place: counts -> exclusive offsets
        tile_counts[static_cast<long long>(b0 + j) * n_members + m] = run;
      run += c[j];
    }
  }
  counts[m] = run;
}

__global__ void dp_rank(const int32_t* __restrict__ member, int n, int n_members,
                        const int32_t* __restrict__ tile_offsets,
                        int32_t* __restrict__ pos) {
  extern __shared__ int32_t smem[];
  int32_t* running = smem;                // [n_members]
  int32_t* warp_cnt = smem + n_members;   // [kDpWarps][n_members]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int m = threadIdx.x; m < n_members; m += blockDim.x) {
    running[m] = tile_offsets[static_cast<long long>(blockIdx.x) * n_members + m];
    for (int w = 0; w < kDpWarps; ++w) warp_cnt[w * n_members + m] = 0;
  }
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kDpTile;
  for (int c = 0; c < kDpChunks; ++c) {
    const long long i = base + static_cast<long long>(c) * kDpThreads + threadIdx.x;
    const int m = i < n ? __ldg(member + i) : -1;
    const bool ok = m >= 0 && m < n_members;
    // Every lane takes part in the match (full mask); lanes that are not
    // counted share the key -1 and never touch shared memory.
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, ok ? m : -1);
    const int rank = __popc(peers & lower);
    const bool leader = ok && rank == 0;
    if (leader) warp_cnt[warp * n_members + m] = __popc(peers);
    __syncthreads();
    int p = 0;
    if (ok) {
      p = running[m] + rank;
      for (int w = 0; w < warp; ++w) p += warp_cnt[w * n_members + m];
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&running[m], __popc(peers));
      warp_cnt[warp * n_members + m] = 0;
    }
    __syncthreads();
    if (i < n) pos[i] = ok ? p : (m < 0 ? -1 : 0);
  }
}

// ---------------------------------------------------------------------------
// seg_masks — replaces the Pallas kernel src/repro/kernels/reassembly.py
// (seg_masks -> _mask_kernel).
//
// On key-sorted columns: new_group[i] = valid[i] & !same(i, i-1) over
// (valid, ev_hi, ev_lo, daq); dup[i] = valid[i] & same & seg[i] == seg[i-1].
// Row 0 compares against an all-zero sentinel.
//
// Bound: bytes. Five 4-byte columns in, two 4-byte masks out: 28 B per row
// (~9 us at 2^20 rows).
//
// Design: one thread per row, reading row i-1 directly (the neighbouring
// thread's row, so the second read hits L1). The TPU kernel's scratch carry
// of the previous block's last row disappears: blocks need nothing from
// each other.
// ---------------------------------------------------------------------------
__global__ void seg_masks_kernel(const int32_t* __restrict__ valid,
                                 const int32_t* __restrict__ hi,
                                 const int32_t* __restrict__ lo,
                                 const int32_t* __restrict__ daq,
                                 const int32_t* __restrict__ seg, int n,
                                 int32_t* __restrict__ new_group,
                                 int32_t* __restrict__ dup) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int pv = 0, ph = 0, pl = 0, pd = 0, ps = 0;
  if (i > 0) {
    pv = __ldg(valid + i - 1);
    ph = __ldg(hi + i - 1);
    pl = __ldg(lo + i - 1);
    pd = __ldg(daq + i - 1);
    ps = __ldg(seg + i - 1);
  }
  const bool same = pv != 0 && __ldg(hi + i) == ph && __ldg(lo + i) == pl &&
                    __ldg(daq + i) == pd;
  const bool ok = __ldg(valid + i) != 0;
  new_group[i] = (ok && !same) ? 1 : 0;
  dup[i] = (ok && same && __ldg(seg + i) == ps) ? 1 : 0;
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int ejfat_lb_route(const int32_t* hdr, const int32_t* iid, int n,
                   const long long* seg_hi, const long long* seg_lo,
                   const int32_t* seg_row, const int32_t* cal,
                   const int32_t* node, const int32_t* base,
                   const int32_t* mask, const int32_t* mvalid, int n_inst,
                   int n_seg, int n_rows, int n_slots, int n_members,
                   int32_t* member_out, int32_t* node_out, int32_t* lane_out,
                   int32_t* valid_out, cudaStream_t stream) {
  constexpr int threads = 256;
  const unsigned blocks = blocks_for(n, threads);
  const int4* h = reinterpret_cast<const int4*>(hdr);
  if (iid != nullptr) {
    lb_route_kernel<true><<<blocks, threads, 0, stream>>>(
        h, iid, n, seg_hi, seg_lo, seg_row, cal, node, base, mask, mvalid,
        n_inst, n_seg, n_rows, n_slots, n_members, member_out, node_out,
        lane_out, valid_out);
  } else {
    lb_route_kernel<false><<<blocks, threads, 0, stream>>>(
        h, nullptr, n, seg_hi, seg_lo, seg_row, cal, node, base, mask, mvalid,
        1, n_seg, n_rows, n_slots, n_members, member_out, node_out, lane_out,
        valid_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int ejfat_dispatch_tile() { return kDpTile; }

// tile_counts: int32 scratch of n_tiles * n_members, n_tiles = ceil(n / tile).
int ejfat_dispatch_plan(const int32_t* member, int n, int n_members,
                        int32_t* tile_counts, int32_t* pos, int32_t* counts,
                        cudaStream_t stream) {
  const unsigned n_tiles = blocks_for(n, kDpTile);
  const size_t hist_bytes = sizeof(int32_t) * n_members;
  dp_count<<<n_tiles, kDpThreads, hist_bytes, stream>>>(member, n, n_members,
                                                         tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_scan<<<blocks_for(n_members, 256), 256, 0, stream>>>(
      tile_counts, static_cast<int>(n_tiles), n_members, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_rank<<<n_tiles, kDpThreads, hist_bytes * (1 + kDpWarps), stream>>>(
      member, n, n_members, tile_counts, pos);
  return static_cast<int>(cudaGetLastError());
}

int ejfat_seg_masks(const int32_t* valid, const int32_t* hi, const int32_t* lo,
                    const int32_t* daq, const int32_t* seg, int n,
                    int32_t* new_group, int32_t* dup, cudaStream_t stream) {
  constexpr int threads = 256;
  seg_masks_kernel<<<blocks_for(n, threads), threads, 0, stream>>>(
      valid, hi, lo, daq, seg, n, new_group, dup);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
