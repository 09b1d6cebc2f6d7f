// EJ-FAT data-plane kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes). Each entry point takes raw device pointers,
// sizes and the CUDA stream, launches on that stream, does not synchronise,
// allocates nothing, and returns the first CUDA error of its calls so the
// Python wrapper can raise on a refused launch.
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
constexpr int kMaxDevices = 64;

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
// Two designs, picked by table bytes (kernels/lb_route.py::_design):
//
// "shared" (tables within the card's shared-memory opt-in, 232,448 B): a
// persistent grid of min(packet groups / 64, SMs x occupancy) blocks, each
// of which first stages every instance's tables in shared memory, then
// walks groups of 4 consecutive packets per thread with a grid stride:
// four 16-byte header loads in flight (the next group's are issued before
// the current group is routed), and each of the four outputs leaves as one
// 16-byte store. The first group's header loads are issued before the
// staging, so they overlap it. Once the window holds a full 1024-thread
// block of packet groups for every SM (2^20 packets: yes; the closed loop's
// ~16k-packet window: no), blocks have 1024 threads and occupancy 1, so
// each SM stages the tables once (132 copies in all); below that, blocks of
// 256 threads spread over more SMs, which the loop's window runs faster
// than on 1024-thread blocks (PERF.md).
//
// "global" (larger tables: farm_1k's 4 x 4096 member slots, 328,480 B; the
// fabric's 14-16 stacked 64-slot instances, whose calendars alone pass the
// opt-in at 16): the same grid and walk, but a block stages only the epoch
// segments (starts and rows, 200 B per instance); the calendar entry and
// the four member fields of each packet are read from device memory
// through the read-only path (__ldg), where L1 and the 50 MB L2 hold the
// tables (farm_1k's are 320 KB) after the first touches. Five gathers per
// packet instead of shared-memory reads: a first design, whose time beside
// the shared design's is in PERF.md.
//
// Shared-memory layout of the "shared" design, per instance i of I (M
// members, R calendar rows of S slots):
//   member[I][M]  int4 {node, base lane, lane mask, valid}: one 16-byte
//                 read per packet instead of four gathers
//   cal[I][R][S]  int32 member ids
//   start[I][17]  u64 segment starts; the row stride is 17 words, not 16,
//                 so the four instances' start s sit in banks 2s+2i, 2s+2i+1
//                 (i = 0..3): a warp whose lanes carry four instance ids
//                 reads four distinct words in one wavefront (a 16-word
//                 stride would put them all in one bank pair, 4-way)
//   row[I][16]    int32 calendar row of each segment
// Four stacked instances of 512 members take 99,104 B (the dynamic shared
// memory opt-in), one instance 24,776 B. The "global" design keeps only
// start and row. With one instance the 16 starts are held in registers.
// Every clip of the Pallas kernel is kept (instance id, row, member), so an
// invalid packet never reads outside a table; the epoch search stays a
// count of starts <= event over all 16 entries, since the compiled starts
// may come in any order.
// ---------------------------------------------------------------------------
constexpr int kSeg = 16;                // epoch segments per instance
constexpr int kSegStride = kSeg + 1;    // u64 words per instance row of starts
constexpr int kLbThreadsLarge = 1024;   // one block per SM
constexpr int kLbThreadsSmall = 256;    // below a full wave of large blocks
constexpr int kLbPackets = 4;           // consecutive packets per thread
constexpr int kLbSpread = 64;           // a block per this many packet groups

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

struct LbTables {
  int4* member;
  int32_t* cal;
  uint64_t* start;
  int32_t* row;
};

__host__ __device__ inline size_t lb_member_bytes(int n_inst, int n_members) {
  return align16(sizeof(int4) * n_inst * static_cast<size_t>(n_members));
}
__host__ __device__ inline size_t lb_cal_bytes(int n_inst, int n_rows, int n_slots) {
  return align16(sizeof(int32_t) * n_inst * static_cast<size_t>(n_rows) * n_slots);
}
__host__ __device__ inline size_t lb_start_bytes(int n_inst) {
  return align16(sizeof(uint64_t) * n_inst * kSegStride);
}
__host__ __device__ inline size_t lb_segment_bytes(int n_inst) {
  return lb_start_bytes(n_inst) + sizeof(int32_t) * n_inst * kSeg;
}
__host__ __device__ inline size_t lb_smem_bytes(int n_inst, int n_rows, int n_slots,
                                                int n_members) {
  return lb_member_bytes(n_inst, n_members) + lb_cal_bytes(n_inst, n_rows, n_slots) +
         lb_segment_bytes(n_inst);
}

__device__ inline LbTables lb_carve(unsigned char* smem, int n_inst, int n_rows, int n_slots,
                                    int n_members) {
  LbTables t;
  t.member = reinterpret_cast<int4*>(smem);
  smem += lb_member_bytes(n_inst, n_members);
  t.cal = reinterpret_cast<int32_t*>(smem);
  smem += lb_cal_bytes(n_inst, n_rows, n_slots);
  t.start = reinterpret_cast<uint64_t*>(smem);
  smem += lb_start_bytes(n_inst);
  t.row = reinterpret_cast<int32_t*>(smem);
  return t;
}

// Header words (and instance ids) of the packets p0 .. p0+3; past n, zero
// words (which fail the magic check) and instance 0.
template <bool MULTI>
__device__ __forceinline__ void load_group(const int4* __restrict__ hdr,
                                           const int32_t* __restrict__ iid, int n, long long p0,
                                           int4 (&w)[kLbPackets], int (&ids)[kLbPackets]) {
  if (p0 + kLbPackets <= n) {
#pragma unroll
    for (int k = 0; k < kLbPackets; ++k) w[k] = __ldg(hdr + p0 + k);
    if (MULTI) {
      if ((reinterpret_cast<uintptr_t>(iid) & 15) == 0) {  // p0 is a multiple of 4
        const int4 v = __ldg(reinterpret_cast<const int4*>(iid + p0));
        ids[0] = v.x; ids[1] = v.y; ids[2] = v.z; ids[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < kLbPackets; ++k) ids[k] = __ldg(iid + p0 + k);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLbPackets; ++k) {
      const bool in = p0 + k < n;
      w[k] = in ? __ldg(hdr + p0 + k) : make_int4(0, 0, 0, 0);
      if (MULTI) ids[k] = in ? __ldg(iid + p0 + k) : 0;
    }
  }
}

// Where route_one reads a calendar entry and a member's four fields.
struct LbSharedTab {  // staged in shared memory
  const int32_t* cal;
  const int4* member;
  __device__ __forceinline__ int calendar(int k) const { return cal[k]; }
  __device__ __forceinline__ int4 fields(int k) const { return member[k]; }
};
struct LbGlobalTab {  // device memory, through the read-only path
  const int32_t* __restrict__ cal;
  const int32_t* __restrict__ node;
  const int32_t* __restrict__ base;
  const int32_t* __restrict__ mask;
  const int32_t* __restrict__ mvalid;
  __device__ __forceinline__ int calendar(int k) const { return __ldg(cal + k); }
  __device__ __forceinline__ int4 fields(int k) const {
    return make_int4(__ldg(node + k), __ldg(base + k), __ldg(mask + k), __ldg(mvalid + k));
  }
};

// One packet through parse -> epoch -> calendar -> member rewrite:
// {member, node, lane, valid}. `start` and `seg_row` are the staged
// segments (shared memory).
template <bool MULTI, class Tab>
__device__ __forceinline__ int4 route_one(int4 w, int inst, const uint64_t* start,
                                          const int32_t* seg_row, const Tab& tab,
                                          const uint64_t (&reg_start)[kSeg], int n_inst,
                                          int n_rows, int n_slots, int n_members) {
  // Parsing stage (paper §III-A): field extract + magic/version check.
  const uint32_t w0 = static_cast<uint32_t>(w.x);
  const uint32_t e_lo = static_cast<uint32_t>(w.w);
  bool ok = ((w0 >> 16) & 0xFFFFu) == kMagic && ((w0 >> 8) & 0xFFu) == kVersion;
  const int entropy = static_cast<int>(static_cast<uint32_t>(w.y) & 0xFFFFu);
  inst = MULTI ? clampi(inst, 0, n_inst - 1) : 0;

  // Calendar Epoch Assignment: segment = (#starts <= event) - 1, u64 compare.
  const uint64_t ev = (static_cast<uint64_t>(static_cast<uint32_t>(w.z)) << 32) | e_lo;
  int cnt = 0;
#pragma unroll
  for (int s = 0; s < kSeg; ++s)
    cnt += ev >= (MULTI ? start[inst * kSegStride + s] : reg_start[s]) ? 1 : 0;
  const int row = seg_row[inst * kSeg + clampi(cnt - 1, 0, kSeg - 1)];

  // Calendar to Member Map: slot = 9 LSBs of the event number.
  const int slot = static_cast<int>(e_lo & kSlotMask);
  const int member = tab.calendar((inst * n_rows + clampi(row, 0, n_rows - 1)) * n_slots + slot);

  // Member Lookup and Rewrite.
  const int4 mt = tab.fields(inst * n_members + clampi(member, 0, n_members - 1));
  ok = ok && row >= 0 && member >= 0 && mt.w > 0;
  return ok ? make_int4(member, mt.x, mt.y + (entropy & mt.z), 1) : make_int4(-1, -1, -1, 0);
}

// Stage the segments (starts as u64 rows of kSegStride, calendar rows).
__device__ __forceinline__ void stage_segments(uint64_t* start, int32_t* row,
                                               const long long* __restrict__ seg_hi,
                                               const long long* __restrict__ seg_lo,
                                               const int32_t* __restrict__ seg_row,
                                               int n_inst) {
  for (int k = threadIdx.x; k < n_inst * kSeg; k += blockDim.x) {
    start[(k / kSeg) * kSegStride + k % kSeg] =
        (static_cast<uint64_t>(static_cast<uint32_t>(__ldg(seg_hi + k))) << 32) |
        static_cast<uint32_t>(__ldg(seg_lo + k));
    row[k] = __ldg(seg_row + k);
  }
}

// The grid-stride walk over groups of 4 packets from group g on (the
// first group's words already in w/ids): route each group while the next
// one's loads are in flight, store each output as one 16-byte store.
template <bool MULTI, class Route>
__device__ __forceinline__ void lb_walk(const int4* __restrict__ hdr,
                                        const int32_t* __restrict__ iid, int n, long long g,
                                        int4 (&w)[kLbPackets], int (&ids)[kLbPackets],
                                        const Route& route, int32_t* __restrict__ member_out,
                                        int32_t* __restrict__ node_out,
                                        int32_t* __restrict__ lane_out,
                                        int32_t* __restrict__ valid_out) {
  const long long n_groups = (static_cast<long long>(n) + kLbPackets - 1) / kLbPackets;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (; g < n_groups; g += step) {
    int4 wn[kLbPackets];
    int idn[kLbPackets] = {0, 0, 0, 0};
    if (g + step < n_groups) load_group<MULTI>(hdr, iid, n, (g + step) * kLbPackets, wn, idn);
    int4 r[kLbPackets];
#pragma unroll
    for (int k = 0; k < kLbPackets; ++k) r[k] = route(w[k], ids[k]);
    const long long p0 = g * kLbPackets;
    if (p0 + kLbPackets <= n) {
      *reinterpret_cast<int4*>(member_out + p0) = make_int4(r[0].x, r[1].x, r[2].x, r[3].x);
      *reinterpret_cast<int4*>(node_out + p0) = make_int4(r[0].y, r[1].y, r[2].y, r[3].y);
      *reinterpret_cast<int4*>(lane_out + p0) = make_int4(r[0].z, r[1].z, r[2].z, r[3].z);
      *reinterpret_cast<int4*>(valid_out + p0) = make_int4(r[0].w, r[1].w, r[2].w, r[3].w);
    } else {
#pragma unroll
      for (int k = 0; k < kLbPackets; ++k) {
        if (p0 + k < n) {
          member_out[p0 + k] = r[k].x;
          node_out[p0 + k] = r[k].y;
          lane_out[p0 + k] = r[k].z;
          valid_out[p0 + k] = r[k].w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kLbPackets; ++k) {
      w[k] = wn[k];
      ids[k] = idn[k];
    }
  }
}

#define LB_ROUTE_PARAMS                                                                    \
  const int4 *__restrict__ hdr, const int32_t *__restrict__ iid, int n,                    \
      const long long *__restrict__ seg_hi, const long long *__restrict__ seg_lo,          \
      const int32_t *__restrict__ seg_row, const int4 *__restrict__ cal,                   \
      const int32_t *__restrict__ node, const int32_t *__restrict__ base,                  \
      const int32_t *__restrict__ mask, const int32_t *__restrict__ mvalid, int n_inst,    \
      int n_rows, int n_slots, int n_members, int32_t *__restrict__ member_out,            \
      int32_t *__restrict__ node_out, int32_t *__restrict__ lane_out,                      \
      int32_t *__restrict__ valid_out

// The "shared" design: all tables staged in shared memory.
template <bool MULTI, int THREADS>
__global__ void __launch_bounds__(THREADS) lb_route_kernel(LB_ROUTE_PARAMS) {
  extern __shared__ __align__(16) unsigned char lb_smem[];
  const LbTables t = lb_carve(lb_smem, n_inst, n_rows, n_slots, n_members);
  const long long n_groups = (static_cast<long long>(n) + kLbPackets - 1) / kLbPackets;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  int4 w[kLbPackets];
  int ids[kLbPackets] = {0, 0, 0, 0};
  if (g < n_groups) load_group<MULTI>(hdr, iid, n, g * kLbPackets, w, ids);

  // Stage the tables: 16-byte copies of the calendars; the four member
  // fields interleaved into one int4 each, read 4 members at a time where
  // the arrays allow 16-byte loads.
  const int nm = n_inst * n_members;
  const bool vec = nm % 4 == 0 && ((reinterpret_cast<uintptr_t>(node) |
                                    reinterpret_cast<uintptr_t>(base) |
                                    reinterpret_cast<uintptr_t>(mask) |
                                    reinterpret_cast<uintptr_t>(mvalid)) & 15) == 0;
  if (vec) {
    for (int q = threadIdx.x; q < nm / 4; q += blockDim.x) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(node) + q);
      const int4 b = __ldg(reinterpret_cast<const int4*>(base) + q);
      const int4 c = __ldg(reinterpret_cast<const int4*>(mask) + q);
      const int4 d = __ldg(reinterpret_cast<const int4*>(mvalid) + q);
      t.member[4 * q + 0] = make_int4(a.x, b.x, c.x, d.x);
      t.member[4 * q + 1] = make_int4(a.y, b.y, c.y, d.y);
      t.member[4 * q + 2] = make_int4(a.z, b.z, c.z, d.z);
      t.member[4 * q + 3] = make_int4(a.w, b.w, c.w, d.w);
    }
  } else {
    for (int k = threadIdx.x; k < nm; k += blockDim.x)
      t.member[k] =
          make_int4(__ldg(node + k), __ldg(base + k), __ldg(mask + k), __ldg(mvalid + k));
  }
  const int n_cal4 = n_inst * n_rows * n_slots / 4;
  for (int k = threadIdx.x; k < n_cal4; k += blockDim.x)
    reinterpret_cast<int4*>(t.cal)[k] = __ldg(cal + k);
  stage_segments(t.start, t.row, seg_hi, seg_lo, seg_row, n_inst);
  __syncthreads();

  uint64_t reg_start[kSeg];
#pragma unroll
  for (int s = 0; s < kSeg; ++s) reg_start[s] = MULTI ? 0 : t.start[s];
  const LbSharedTab tab{t.cal, t.member};
  lb_walk<MULTI>(
      hdr, iid, n, g, w, ids,
      [&](int4 wk, int inst) {
        return route_one<MULTI>(wk, inst, t.start, t.row, tab, reg_start, n_inst, n_rows,
                                n_slots, n_members);
      },
      member_out, node_out, lane_out, valid_out);
}

// The "global" design: segments in shared memory, calendars and member
// fields read from device memory.
template <bool MULTI, int THREADS>
__global__ void __launch_bounds__(THREADS) lb_route_global_kernel(LB_ROUTE_PARAMS) {
  extern __shared__ __align__(16) unsigned char lb_smem[];
  uint64_t* start = reinterpret_cast<uint64_t*>(lb_smem);
  int32_t* row = reinterpret_cast<int32_t*>(lb_smem + lb_start_bytes(n_inst));
  const long long n_groups = (static_cast<long long>(n) + kLbPackets - 1) / kLbPackets;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  int4 w[kLbPackets];
  int ids[kLbPackets] = {0, 0, 0, 0};
  if (g < n_groups) load_group<MULTI>(hdr, iid, n, g * kLbPackets, w, ids);
  stage_segments(start, row, seg_hi, seg_lo, seg_row, n_inst);
  __syncthreads();

  uint64_t reg_start[kSeg];
#pragma unroll
  for (int s = 0; s < kSeg; ++s) reg_start[s] = MULTI ? 0 : start[s];
  const LbGlobalTab tab{reinterpret_cast<const int32_t*>(cal), node, base, mask, mvalid};
  lb_walk<MULTI>(
      hdr, iid, n, g, w, ids,
      [&](int4 wk, int inst) {
        return route_one<MULTI>(wk, inst, start, row, tab, reg_start, n_inst, n_rows, n_slots,
                                n_members);
      },
      member_out, node_out, lane_out, valid_out);
}

using LbKernel = void (*)(const int4*, const int32_t*, int, const long long*, const long long*,
                          const int32_t*, const int4*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, int, int, int, int, int32_t*,
                          int32_t*, int32_t*, int32_t*);

// The kernel variants, [design (0 shared, 1 global)][MULTI][large blocks].
const LbKernel kLbKernels[2][2][2] = {
    {{lb_route_kernel<false, kLbThreadsSmall>, lb_route_kernel<false, kLbThreadsLarge>},
     {lb_route_kernel<true, kLbThreadsSmall>, lb_route_kernel<true, kLbThreadsLarge>}},
    {{lb_route_global_kernel<false, kLbThreadsSmall>,
      lb_route_global_kernel<false, kLbThreadsLarge>},
     {lb_route_global_kernel<true, kLbThreadsSmall>,
      lb_route_global_kernel<true, kLbThreadsLarge>}}};

// Per device: SM count, the shared-memory opt-in, and the occupancy of each
// kernel variant at the shared-memory size it was last launched with.
struct LbLaunchCache {
  int sms = 0;
  int optin = 0;
  int occ[2][2][2] = {};           // [design][MULTI][large]
  size_t occ_smem[2][2][2] = {};
};
LbLaunchCache g_lb_cache[kMaxDevices];

// Per-device set-up on the first call: the opt-in of every variant (done
// before any CUDA-graph capture: the fused engine warms up first).
cudaError_t lb_cache(LbLaunchCache** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  LbLaunchCache& c = g_lb_cache[dev];
  if (c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int d = 0; d < 2; ++d)
      for (int m = 0; m < 2; ++m)
        for (int l = 0; l < 2; ++l)
          if (err == cudaSuccess)
            err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kLbKernels[d][m][l]),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, c.optin);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      c.sms = 0;
      return err;
    }
  }
  *out = &c;
  return cudaSuccess;
}

template <bool MULTI>
cudaError_t lb_route_launch(int design, const int4* hdr, const int32_t* iid, int n,
                            const long long* seg_hi, const long long* seg_lo,
                            const int32_t* seg_row, const int4* cal, const int32_t* node,
                            const int32_t* base, const int32_t* mask, const int32_t* mvalid,
                            int n_inst, int n_rows, int n_slots, int n_members,
                            int32_t* member_out, int32_t* node_out, int32_t* lane_out,
                            int32_t* valid_out, cudaStream_t stream) {
  if (design != 0 && design != 1) return cudaErrorInvalidValue;
  LbLaunchCache* cp = nullptr;
  cudaError_t err = lb_cache(&cp);
  if (err != cudaSuccess) return err;
  LbLaunchCache& c = *cp;
  const size_t smem = design == 0 ? lb_smem_bytes(n_inst, n_rows, n_slots, n_members)
                                  : lb_segment_bytes(n_inst);
  if (smem > static_cast<size_t>(c.optin)) return cudaErrorInvalidValue;
  const long long groups = (static_cast<long long>(n) + kLbPackets - 1) / kLbPackets;
  // Large blocks once there is a full block of packet groups for every SM.
  const bool large = groups >= static_cast<long long>(c.sms) * kLbThreadsLarge;
  const int threads = large ? kLbThreadsLarge : kLbThreadsSmall;
  const LbKernel kernel = kLbKernels[design][MULTI][large];
  if (c.occ_smem[design][MULTI][large] != smem) {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    c.occ[design][MULTI][large] = occ;
    c.occ_smem[design][MULTI][large] = smem;
  }
  // A block per kLbSpread packet groups, up to the resident limit.
  const long long want = (groups + kLbSpread - 1) / kLbSpread;
  const long long most = static_cast<long long>(c.sms) * c.occ[design][MULTI][large];
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  kernel<<<blocks, threads, smem, stream>>>(hdr, iid, n, seg_hi, seg_lo, seg_row, cal, node,
                                            base, mask, mvalid, n_inst, n_rows, n_slots,
                                            n_members, member_out, node_out, lane_out,
                                            valid_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dispatch_plan — replaces the Pallas kernel src/repro/kernels/dispatch.py
// (dispatch_plan -> _plan_kernel).
//
// pos_i = #{j < i : member_j == member_i} (stable), counts[m] = total per
// member; pos = -1 for member < 0; a member >= n_members gets pos 0 and is
// not counted (the Pallas one-hot over arange(M) is all zero there).
//
// Bound: bytes. 4 B read and 4 B written per packet (~2.5 us at 2^20).
//
// Design: one launch, one pass over `member`, with a decoupled look-back
// across tiles (the TPU kernel's in-order carry becomes published per-tile
// counts). A block takes a tile of 4096 packets, its tile id drawn from a
// device counter (not blockIdx.x), so a tile waits only on tiles whose
// blocks have already started: forward progress holds however the blocks
// are scheduled.
//   1. Each warp loads its 512 contiguous packets into registers (16 per
//      lane, coalesced) and counts them into its own histogram row in
//      shared memory (shared-memory atomics).
//   2. After one barrier, each thread takes n_members / 256 members (2 at
//      M = 512): it turns the 8 warp counts into exclusive warp offsets and
//      the tile's aggregate, and publishes the aggregate as one 64-bit word
//      per (tile, member): flag in the high half (1 = aggregate, 2 =
//      inclusive prefix), the 32-bit count in the low half (a count reaches
//      at most N < 2^31, so a one-member skew cannot spill into the flag).
//   3. Look-back in two levels. Tiles form groups of 8. (a) A tile sums the
//      aggregates of its group's earlier tiles (at most 7 words, one read
//      round); the group's last tile publishes the group's aggregate. Then
//      each warp computes, for its 16 chunks, the lanes holding the same
//      member (ballots over the member's bits), while the other groups
//      publish. (b) The group's last tile looks back over the earlier
//      groups' words (16 per round, nearest first: add aggregates until an
//      inclusive prefix is found) and publishes the group's inclusive
//      prefix; the group's other tiles wait for the previous group's
//      inclusive prefix, one word. A one-level look-back over tiles, when
//      all tiles publish at once (256 resident tiles at 2^20), reads every
//      predecessor's word, ~T^2/2 x M words (134 MB at 2^20, M = 512); the
//      groups bound it to ~4.5 words per tile and member. A word not yet
//      published is read again after a pause. The tile holding the last
//      packet writes counts. Each word carries its own value, so relaxed
//      64-bit accesses at GPU scope suffice: no other memory is ordered by
//      them, and an acquire on each would serialise a round's loads.
//   4. Each warp walks its 16 register chunks in order:
//      pos = (tile prefix + warp offset + running count, one shared row per
//      warp, bumped by the group leader between two __syncwarp) + the rank
//      among the lower lanes of the group. Stores are coalesced.
// What holds it far from its bound on the H100 is this chain of phases,
// each a latency (scripts/dispatch_plan_phases_torch.py; PERF.md): the
// tile id, the loads, the ballots (instruction-bound, and slower on the
// SMs that hold two tiles), the wait for the slowest tile of the earlier
// groups, and the 16 dependent steps of the rank walk.
// The words and the tile counter live in a scratch the host entry clears
// with cudaMemsetAsync on the same stream before the launch, so a CUDA
// graph replays the clear with the kernel and no reset value comes from
// the host. Counts are int32 and exact (the Pallas f32 carry is exact only
// below 2^24 per member).
//
// Members past kDpMaxMembers (1024): the grid's second dimension splits the
// members into chunks of 1024, and chunk c's blocks run the whole scheme
// above over the members [1024c, 1024c + 1024) with their own tile counter
// and words: every block reads its tile's packets, counts and ranks only
// the chunk's members and writes only their positions (chunk 0 also writes
// those of members outside [0, n_members)). The histograms stay 8 x 1024
// int32 (32 KB, no opt-in, the occupancy of M = 1024), the members are read
// once per chunk (L2 holds them: 4 MB at 2^20), and the scratch grows as
// chunks x (tiles + groups) x 1024 words: 37.7 MB at 2^20 packets and
// M = 16,384, cleared by one memset. At M <= 1024 the kernel is compiled
// without chunks (CHUNKED = false): the one-chunk scheme it was, at its
// registers and times. A design whose scratch does
// not grow with M x tiles (per-tile lists of the members present) is later
// work (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kDpThreads = 256;
constexpr int kDpWarps = kDpThreads / 32;
constexpr int kDpPerLane = 16;
constexpr int kDpWarpSpan = 32 * kDpPerLane;      // 512 packets per warp
constexpr int kDpTile = kDpThreads * kDpPerLane;  // 4096 packets per block
constexpr int kDpMaxMembers = 1024;               // kernels/dispatch.py CHUNK_MEMBERS
constexpr int kDpMembersPerThread = kDpMaxMembers / kDpThreads;
constexpr int kDpGroup = 8;                       // tiles per group of the look-back
constexpr int kDpLookBack = 16;                   // predecessor group words per read round
constexpr unsigned long long kDpAggregate = 1ull << 32;
constexpr unsigned long long kDpInclusive = 2ull << 32;

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A predecessor publishes within microseconds of its start; a look-back
// stalled for this long is a fault, and the kernel traps (the launch then
// reports an error) instead of hanging the card.
constexpr uint64_t kDpWaitLimitNs = 4000000000ull;

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A pause before reading words that were not published yet; traps once
// the wait since `t0` (0: not started) passes kDpWaitLimitNs.
__device__ __forceinline__ void dp_pause(uint64_t& t0) {
  const uint64_t now = global_ns();
  if (t0 == 0) t0 = now;
  else if (now - t0 > kDpWaitLimitNs) __trap();
  __nanosleep(200);
}

// The word at `p` once its flag reaches `flag_at_least`.
__device__ __forceinline__ unsigned long long dp_poll(const unsigned long long* p,
                                                      unsigned flag_at_least) {
  uint64_t t0 = 0;
  unsigned long long v = ld_relaxed(p);
  while ((v >> 32) < flag_at_least) {
    dp_pause(t0);
    v = ld_relaxed(p);
  }
  return v;
}

// Exclusive prefix of one member over groups 0 .. group-1; `col` points at
// that member's word of group 0, `stride` words apart per group: read
// kDpLookBack words per round, nearest first, adding aggregates up to the
// first inclusive prefix; from a word not yet published, read again after a
// pause.
__device__ __forceinline__ int dp_look_back(const unsigned long long* col, int stride,
                                            int group) {
  int prefix = 0;
  int j = group - 1;
  uint64_t t0 = 0;
  for (;;) {
    unsigned long long v[kDpLookBack];
#pragma unroll
    for (int k = 0; k < kDpLookBack; ++k)  // group 0 is always inclusive, so k <= j
      v[k] = k <= j ? ld_relaxed(col + static_cast<long long>(j - k) * stride) : kDpInclusive;
    int taken = 0;
    bool found = false, blocked = false;
#pragma unroll
    for (int k = 0; k < kDpLookBack; ++k) {
      if (!found && !blocked) {
        if ((v[k] >> 32) == 0) {
          blocked = true;
        } else {
          prefix += static_cast<int>(static_cast<uint32_t>(v[k]));
          ++taken;
          found = (v[k] >> 32) == 2;
        }
      }
    }
    if (found) return prefix;
    if (blocked) dp_pause(t0);
    j -= taken;
  }
}

template <bool CHUNKED>
__global__ void __launch_bounds__(kDpThreads) dispatch_plan_kernel(
    const int32_t* __restrict__ member, int n, int n_members_all, int n_tiles,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ pos,
    int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];  // [kDpWarps][n_members]
  __shared__ int tile_s;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  // This block's chunk of members: [m0, m0 + n_members) (without chunks:
  // chunk 0, all members).
  const int chunk = CHUNKED ? static_cast<int>(blockIdx.y) : 0;
  const int m0 = chunk * kDpMaxMembers;
  const int n_members = CHUNKED ? min(kDpMaxMembers, n_members_all - m0) : n_members_all;
  unsigned int* tile_counter = reinterpret_cast<unsigned int*>(scratch + chunk);
  unsigned long long* tile_words =
      scratch + (CHUNKED ? gridDim.y : 1) +
      (CHUNKED ? static_cast<long long>(chunk) *
                     (n_tiles + (n_tiles + kDpGroup - 1) / kDpGroup) * kDpMaxMembers
               : 0);

  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(tile_counter, 1u));
  for (int k = threadIdx.x; k < kDpWarps * n_members; k += kDpThreads) hist[k] = 0;
  __syncthreads();
  const int tile = tile_s;
  const long long first = static_cast<long long>(tile) * kDpTile + warp * kDpWarpSpan + lane;

  // 1. Load once; per-warp histogram (shared-memory atomics into the warp's
  // own row). key is the member's index in the chunk; members outside the
  // chunk are never counted here.
  int raw[kDpPerLane];
  unsigned peers[kDpPerLane];
#pragma unroll
  for (int c = 0; c < kDpPerLane; ++c) {
    const long long i = first + c * 32;
    raw[c] = i < n ? __ldg(member + i) : -1;
  }
  // in the chunk: 0 <= raw - m0 < n_members (unsigned: raw < 0 is never in)
  auto in_chunk = [&](int r) {
    return CHUNKED ? static_cast<unsigned>(r) - static_cast<unsigned>(m0) <
                         static_cast<unsigned>(n_members)
                   : r >= 0 && r < n_members;
  };
  int32_t* run = hist + warp * n_members;
#pragma unroll
  for (int c = 0; c < kDpPerLane; ++c)
    if (in_chunk(raw[c])) atomicAdd(&run[raw[c] - m0], 1);
  __syncthreads();

  // 2. Warp offsets and the tile aggregate; publish the aggregate.
  const int group = tile / kDpGroup;
  const int g0 = group * kDpGroup;
  const bool group_last = tile == g0 + kDpGroup - 1 || tile == n_tiles - 1;
  unsigned long long* group_words = tile_words + static_cast<long long>(n_tiles) * n_members;
  int agg[kDpMembersPerThread];
#pragma unroll
  for (int j = 0; j < kDpMembersPerThread; ++j) {
    const int m = threadIdx.x + j * kDpThreads;
    agg[j] = 0;
    if (m < n_members) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kDpWarps; ++w) {
        const int cnt = hist[w * n_members + m];
        hist[w * n_members + m] = sum;
        sum += cnt;
      }
      agg[j] = sum;
      st_relaxed(tile_words + static_cast<long long>(tile) * n_members + m,
                 kDpAggregate | static_cast<uint32_t>(sum));
    }
  }
  // 3a. The aggregates of the group's earlier tiles, both members of a
  // thread's pair read in one round (a word not yet published is read again
  // after a pause); the group's last tile publishes the group's aggregate
  // (group 0: its inclusive prefix).
  const int in_count = tile - g0;
  int in_group[kDpMembersPerThread];
#pragma unroll
  for (int p = 0; p < kDpMembersPerThread; p += 2) {
    int m[2];
    bool has[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      m[q] = threadIdx.x + (p + q) * kDpThreads;
      has[q] = m[q] < n_members;
      in_group[p + q] = 0;
    }
    if (!has[0]) continue;
    unsigned long long v[2][kDpGroup - 1];
#pragma unroll
    for (int k = 0; k < kDpGroup - 1; ++k)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        v[q][k] = has[q] && k < in_count
                      ? ld_relaxed(tile_words + static_cast<long long>(g0 + k) * n_members + m[q])
                      : kDpAggregate;
    for (uint64_t t0 = 0;;) {
      bool missing = false;
#pragma unroll
      for (int k = 0; k < kDpGroup - 1; ++k)
#pragma unroll
        for (int q = 0; q < 2; ++q) missing |= (v[q][k] >> 32) == 0;
      if (!missing) break;
      dp_pause(t0);
#pragma unroll
      for (int k = 0; k < kDpGroup - 1; ++k)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if ((v[q][k] >> 32) == 0)
            v[q][k] = ld_relaxed(tile_words + static_cast<long long>(g0 + k) * n_members + m[q]);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int k = 0; k < kDpGroup - 1; ++k)
        in_group[p + q] += static_cast<int>(static_cast<uint32_t>(v[q][k]));
      if (group_last && has[q])
        st_relaxed(group_words + static_cast<long long>(group) * n_members + m[q],
                   (group == 0 ? kDpInclusive : kDpAggregate) |
                       static_cast<uint32_t>(in_group[p + q] + agg[p + q]));
    }
  }

  // The lanes of each chunk holding the same member, for the ranks of step
  // 4, computed while the other groups publish: the AND over the key's bits
  // of each bit's ballot (or its complement), bit-major so the 16 chunks'
  // ballots are independent of each other (one __match_any_sync per chunk
  // is a chain of long-latency instructions).
  const int bits = 32 - __clz(n_members);  // keys 0 .. n_members
#pragma unroll
  for (int c = 0; c < kDpPerLane; ++c) peers[c] = 0xFFFFFFFFu;
#pragma unroll 1
  for (int b = 0; b < bits; ++b) {
#pragma unroll
    for (int c = 0; c < kDpPerLane; ++c) {
      const bool ok = in_chunk(raw[c]);
      const unsigned bit = (static_cast<unsigned>(ok ? raw[c] - m0 : n_members) >> b) & 1u;
      const unsigned ones = __ballot_sync(0xFFFFFFFFu, bit);
      peers[c] &= bit ? ones : ~ones;
    }
  }

  // 3b. The group's exclusive prefix: the group's last tile looks back
  // over the earlier groups' words and publishes the group's inclusive
  // prefix; the other tiles wait for the previous group's inclusive prefix.
  // Fold the tile's prefix into every warp's running row.
#pragma unroll
  for (int j = 0; j < kDpMembersPerThread; ++j) {
    const int m = threadIdx.x + j * kDpThreads;
    if (m >= n_members) continue;
    int before = 0;
    if (group > 0) {
      const unsigned long long* gcol = group_words + m;
      if (group_last) {
        before = dp_look_back(gcol, n_members, group);
        st_relaxed(group_words + static_cast<long long>(group) * n_members + m,
                   kDpInclusive | static_cast<uint32_t>(before + in_group[j] + agg[j]));
      } else {
        before = static_cast<int>(static_cast<uint32_t>(
            dp_poll(gcol + static_cast<long long>(group - 1) * n_members, 2)));
      }
    }
    const int prefix = before + in_group[j];
    if (tile == n_tiles - 1) counts[m0 + m] = prefix + agg[j];
#pragma unroll
    for (int w = 0; w < kDpWarps; ++w) hist[w * n_members + m] += prefix;
  }
  __syncthreads();

  // 4. Ranks, in packet order within the warp's sub-range. A position
  // belongs to the member's chunk; chunk 0 also writes -1 for members < 0
  // and 0 for members >= n_members (uncounted).
#pragma unroll
  for (int c = 0; c < kDpPerLane; ++c) {
    const long long i = first + c * 32;
    const bool ok = in_chunk(raw[c]);
    const int m = raw[c] - m0;
    const int p = ok ? run[m] + __popc(peers[c] & lower) : (raw[c] < 0 ? -1 : 0);
    __syncwarp();
    if (ok && (peers[c] & lower) == 0) run[m] += __popc(peers[c]);
    __syncwarp();
    const bool mine = !CHUNKED || ok || (chunk == 0 && (raw[c] < 0 || raw[c] >= n_members_all));
    if (i < n && mine) pos[i] = p;
  }
}

inline long long dp_tiles(int n) { return (static_cast<long long>(n) + kDpTile - 1) / kDpTile; }
inline long long dp_groups(long long n_tiles) { return (n_tiles + kDpGroup - 1) / kDpGroup; }
inline int dp_chunk_members(int n_members) {
  return n_members < kDpMaxMembers ? n_members : kDpMaxMembers;
}
inline long long dp_chunks(int n_members) {
  return (n_members + kDpMaxMembers - 1) / kDpMaxMembers;
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

// Shared memory one block of lb_route's "shared" design stages its tables
// in (design 0), or the "global" design its segments in (design 1).
long long ejfat_lb_route_smem_bytes(int design, int n_inst, int n_rows, int n_slots,
                                    int n_members) {
  return static_cast<long long>(design == 0
                                    ? lb_smem_bytes(n_inst, n_rows, n_slots, n_members)
                                    : lb_segment_bytes(n_inst));
}

// design: 0 "shared", 1 "global"; seg_* have kSeg (16) entries per
// instance; cal rows n_slots (a multiple of 4) int32; hdr and cal 16-byte
// aligned.
int ejfat_lb_route(int design, const int32_t* hdr, const int32_t* iid, int n,
                   const long long* seg_hi, const long long* seg_lo,
                   const int32_t* seg_row, const int32_t* cal,
                   const int32_t* node, const int32_t* base,
                   const int32_t* mask, const int32_t* mvalid, int n_inst,
                   int n_rows, int n_slots, int n_members,
                   int32_t* member_out, int32_t* node_out, int32_t* lane_out,
                   int32_t* valid_out, cudaStream_t stream) {
  const int4* h = reinterpret_cast<const int4*>(hdr);
  const int4* c = reinterpret_cast<const int4*>(cal);
  const cudaError_t err =
      iid != nullptr
          ? lb_route_launch<true>(design, h, iid, n, seg_hi, seg_lo, seg_row, c, node, base, mask,
                                  mvalid, n_inst, n_rows, n_slots, n_members, member_out,
                                  node_out, lane_out, valid_out, stream)
          : lb_route_launch<false>(design, h, nullptr, n, seg_hi, seg_lo, seg_row, c, node, base,
                                   mask, mvalid, 1, n_rows, n_slots, n_members, member_out,
                                   node_out, lane_out, valid_out, stream);
  return static_cast<int>(err);
}

// 64-bit words of dispatch_plan's scratch: one tile counter per chunk of
// members, then per chunk one word per (tile, member) and one per (group of
// tiles, member), chunks of min(n_members, 1024) members.
long long ejfat_dispatch_scratch_words(int n, int n_members) {
  return dp_chunks(n_members) *
         (1 + (dp_tiles(n) + dp_groups(dp_tiles(n))) * dp_chunk_members(n_members));
}

int ejfat_dispatch_plan(const int32_t* member, int n, int n_members,
                        unsigned long long* scratch, int32_t* pos, int32_t* counts,
                        cudaStream_t stream) {
  const long long n_tiles = dp_tiles(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * ejfat_dispatch_scratch_words(n, n_members),
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(dp_chunks(n_members)));
  const size_t smem = sizeof(int32_t) * kDpWarps * dp_chunk_members(n_members);
  if (n_members > kDpMaxMembers)
    dispatch_plan_kernel<true><<<grid, kDpThreads, smem, stream>>>(
        member, n, n_members, static_cast<int>(n_tiles), scratch, pos, counts);
  else
    dispatch_plan_kernel<false><<<grid, kDpThreads, smem, stream>>>(
        member, n, n_members, static_cast<int>(n_tiles), scratch, pos, counts);
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
