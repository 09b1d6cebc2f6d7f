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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// farm_serve — the bounded Lindley recursion of the farm queues
// (repro/simnet/queues.py::_serve_jnp and the fused step's lax.scan at
// repro/simnet/fused.py:276-288; the numpy engine _serve_np is the op order).
//
// Rows come sorted by (member, arrival, row) with member m's rows at
// [offsets[m], offsets[m+1]). One thread per member walks its rows in order:
//
//   t  = max(t_row, t_last)        (server time never rewinds)
//   w  = max(w - (t - t_last), 0)  (the server drains in real time)
//   drop = w + s > cap             (drop-tail on work-seconds)
//   dep  = (t + w) + s, w = w + s  (accepted rows only)
//   w_max = max(w_max, w), t_last = t
//
// Bound: the dependent chain. Per row it moves 25 bytes (t, s in; dep, drop
// out) against ~10 dependent float64 operations, so the longest member's
// rows x that chain's latency, not bytes or the FP64 rate, is the limit.
// Design: simple and right first. The next row's two loads are issued
// before the current row's chain, so the chain does not wait on memory.
// ---------------------------------------------------------------------------

constexpr int kServeThreads = 128;

__global__ void farm_serve_kernel(const double* __restrict__ t, const double* __restrict__ s,
                                  const int32_t* __restrict__ offsets,
                                  const double* __restrict__ w0, const double* __restrict__ t0,
                                  const double* __restrict__ cap, int n_members,
                                  double* __restrict__ dep, uint8_t* __restrict__ drop,
                                  double* __restrict__ w_out, double* __restrict__ t_last_out,
                                  double* __restrict__ w_max_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n_members) return;
  const int lo = offsets[m], hi = offsets[m + 1];
  const double c = cap[m];
  double w = w0[m], t_last = t0[m], w_max = w0[m];
  double t_next = 0.0, s_next = 0.0;
  if (lo < hi) {
    t_next = t[lo];
    s_next = s[lo];
  }
  for (int r = lo; r < hi; ++r) {
    const double tr = t_next, sr = s_next;
    if (r + 1 < hi) {
      t_next = t[r + 1];
      s_next = s[r + 1];
    }
    const double tt = fmax(tr, t_last);
    w = fmax(__dsub_rn(w, __dsub_rn(tt, t_last)), 0.0);
    const double ws = __dadd_rn(w, sr);
    const bool d = ws > c;
    dep[r] = d ? INFINITY : __dadd_rn(__dadd_rn(tt, w), sr);
    drop[r] = d ? 1 : 0;
    if (!d) w = ws;
    w_max = fmax(w_max, w);
    t_last = tt;
  }
  w_out[m] = w;
  t_last_out[m] = t_last;
  w_max_out[m] = w_max;
}

// ---------------------------------------------------------------------------
// seq_cumsum — the downlink FIFO's running sum in numpy's order
// (repro/simnet/fused.py:242 jnp.cumsum, which the host engine computes with
// np.cumsum in repro/simnet/links.py:76).
//
// Float addition does not associate, and the host's sequential sum feeds
// drop-tail comparisons downstream, so the fused step adds in row order to
// stay bit-equal (torch.cumsum on the card adds in a tree). Bound: the
// chain of n dependent float64 adds. Design: one block; its threads stage a
// tile in shared memory with coalesced loads, thread 0 adds it up in order,
// and the block writes it back.
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanTile = 4096;

__global__ void seq_cumsum_kernel(const double* __restrict__ x, int n,
                                  double* __restrict__ out) {
  __shared__ double tile[kScanTile];
  double acc = 0.0;
  for (int base = 0; base < n; base += kScanTile) {
    const int len = min(kScanTile, n - base);
    for (int i = threadIdx.x; i < len; i += blockDim.x) tile[i] = x[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int i = 0;
      if (base == 0) {  // np.cumsum starts from the first element, not 0 + x0
        acc = tile[0];
        i = 1;
      }
      for (; i < len; ++i) {
        acc = __dadd_rn(acc, tile[i]);
        tile[i] = acc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) out[base + i] = tile[i];
    __syncthreads();
  }
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
constexpr unsigned kFull = 0xffffffffu;

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
// at and past offsets[n_members] are not touched.
int ejfat_farm_serve(const double* t, const double* s, const int32_t* offsets,
                     const double* w0, const double* t0, const double* cap, int n_members,
                     double* dep, uint8_t* drop, double* w_out, double* t_last_out,
                     double* w_max_out, cudaStream_t stream) {
  const int blocks = (n_members + kServeThreads - 1) / kServeThreads;
  farm_serve_kernel<<<blocks, kServeThreads, 0, stream>>>(
      t, s, offsets, w0, t0, cap, n_members, dep, drop, w_out, t_last_out, w_max_out);
  return static_cast<int>(cudaGetLastError());
}

// w float64[m], 1 <= m <= 32, all positive; n_slots <= 512; out int32[n_slots]
// is written only when *do_sw is true.
int ejfat_seq_cumsum(const double* x, int n, double* out, cudaStream_t stream) {
  if (n > 0) seq_cumsum_kernel<<<1, kScanThreads, 0, stream>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}

int ejfat_build_calendar(const double* w, int m, const bool* do_sw, int n_slots,
                         int32_t* out, cudaStream_t stream) {
  if (m < 1 || m > kMaxCalMembers || n_slots < 1 || n_slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  build_calendar_kernel<<<1, 32, 0, stream>>>(w, m, do_sw, n_slots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
