// Task refresh: the outstanding transfer and timer tasks of every
// workflow lane, computed from its replayed state, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's refresh
// (cadence_tpu/ops/refresh.py:79, refresh_tasks_device) is eager jnp code
// that XLA fuses into a few loops. The port's eager version
// (ops/refresh.py refresh_tasks_plain) makes about 123 launches a call:
// each one reads the state's columns again and writes its intermediates
// to device memory, and each costs the host a launch. This kernel
// computes the same 12 arrays of RefreshedTasks, bit for bit, in one
// launch.
//
// What bounds it on this card: bytes. Each lane's six state tables
// (exec_info, activities, timers, children, cancels, signals) are read
// once: 145 int32 a lane at the retry_deep caps, 921 at the default caps.
// Its 12 outputs are written once: about 98 and 314 bytes a lane. The
// integer work, about 20 operations an activity candidate, takes less
// than the bytes at 3.35 TB/s (chip_smoke.py refresh_bound).
//
// What the design does about it:
// - the tables are batch-major and contiguous ([B, slots, fields]), so a
//   block's tile of lanes is one contiguous slab of each table. The block
//   copies the six slabs into shared memory with 16-byte cp.async
//   requests, neighbouring threads on neighbouring addresses, all of them
//   in flight at once, and then works from shared memory. No
//   intermediate goes to device memory;
// - a lane is worked by a group of G threads, G the power of two at or
//   above a quarter of the widest slot table, at most 32: 1 at the
//   retry_deep caps (4 activity slots), 8 at the default ones (32).
//   Thread j of a group takes slots j, j + G, ... of every table, so that
//   32 activity slots spread over a quarter of a warp, and the group
//   reduces each timer's argmin with warp shuffles. A thread a slot (G 4
//   and 32) timed 14% and 70% slower than this: the idle threads of the
//   narrow tables and the five-round shuffles of the wide ones take issue
//   slots (PERF.md). Slot s of lane l is row l * cap + s of its slab, the
//   slab copied as it lies, with no padding: at a thread a lane the
//   activity rows of a warp's lanes stride 76 int32, 4-way bank
//   conflicts, which timed no slower than 2 threads a lane;
// - after the shuffles every thread of a group holds the group's result,
//   so the [B, A], [B, C], [B, RC] and [B, SG] arrays are written by slot
//   and the [B, 5] and [B, 3] rows by component: neighbouring threads
//   write neighbouring addresses;
// - a block takes the most lanes, a power of two, whose slabs fit the 48
//   KB a block gets without opting in, with whole warps and at most 256
//   threads (ops/refresh.py refresh_plan): 64 lanes and 37 KB at the
//   retry_deep caps, 8 lanes and 29 KB at the default ones, 64 threads
//   either way, so that several blocks share an SM and one block's copy
//   overlaps another's work. Tables too wide for one warp's lanes in 48
//   KB take one warp a block and opt in to more.
//
// The tie rules are the eager version's: the activity timer takes, within
// each of its five candidate kinds, the least expiry and then the least
// schedule id, with attempt and version the max over that kind's tied
// winners (attempt 0 from every other slot); across kinds the least
// (expiry, schedule id), then the earliest kind. int32 sums wrap, and an
// expiry of INT32_MAX reads as absent.
//
// The caps and the geometry are launch parameters, so one build serves
// every Capacities: ops/refresh.py refresh_plan owns the geometry (threads
// a lane, lanes a block, the slabs' offsets in shared memory) and checks
// it against the card's limits before it launches. The launch allocates
// nothing, runs on the caller's stream and returns a cudaError_t; the
// Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// ---- schema constants (ops/schema.py), the columns the refresh reads
enum Exec {
  X_STATE = 0, X_LAST_PROCESSED_EVENT = 5, X_START_TS = 6,
  X_WORKFLOW_TIMEOUT = 7, X_DEC_SCHEDULE_ID = 10, X_DEC_STARTED_ID = 11,
  X_DEC_TIMEOUT = 12, X_DEC_ATTEMPT = 13, X_DEC_STARTED_TS = 15, X_N = 25
};
enum Act {
  AC_OCC = 0, AC_VERSION = 1, AC_SCHEDULE_ID = 2, AC_SCHEDULED_TS = 4,
  AC_STARTED_ID = 5, AC_STARTED_TS = 6, AC_SCH_TO_START = 8,
  AC_SCH_TO_CLOSE = 9, AC_START_TO_CLOSE = 10, AC_HEARTBEAT = 11,
  AC_ATTEMPT = 14, AC_LAST_HB_TS = 17, AC_N = 19
};
enum Tim { TI_OCC = 0, TI_VERSION = 1, TI_STARTED_ID = 2, TI_EXPIRY_TS = 4,
           TI_N = 6 };
enum Chd { CH_OCC = 0, CH_INITIATED_ID = 2, CH_STARTED_ID = 4, CH_N = 8 };
// external cancels and signals share one column layout:
// occupied, version, initiated id, initiated batch id
enum Ext { EXT_OCC = 0, EXT_INITIATED_ID = 2, EXT_N = 4 };

// ---- core/ids.py and core/enums.py
constexpr int EMPTY_EVENT_ID = -23;
constexpr int WF_CREATED = 0, WF_RUNNING = 1;

constexpr int BIG = INT_MAX;  // an absent candidate
constexpr int N_KINDS = 5;    // the activity timer's candidate kinds
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  const int* ex;   // [B, X_N]
  const int* act;  // [B, A, AC_N]
  const int* tim;  // [B, TM, TI_N]
  const int* chd;  // [B, C, CH_N]
  const int* rc;   // [B, RC, EXT_N]
  const int* sg;   // [B, SG, EXT_N]
};

// the 12 fields of RefreshedTasks (ops/refresh.py), in its order
struct Outs {
  unsigned char* close_transfer;          // [B] bool
  int* workflow_timeout_ts;               // [B]
  int* decision_transfer;                 // [B]
  int* decision_timer;                    // [B, 3]
  int* activity_transfer;                 // [B, A]
  int* activity_timer;                    // [B, 5]
  int* user_timer;                        // [B, 3]
  int* child_transfer;                    // [B, C]
  int* cancel_transfer;                   // [B, RC]
  int* signal_transfer;                   // [B, SG]
  unsigned char* first_decision_pending;  // [B] bool
  int* start_ts;                          // [B]
};

// B lanes; slot caps; threads a lane (a power of two, at most 32); lanes
// a block; the int32 offsets in shared memory of the activity, timer,
// child, cancel and signal slabs (exec_info's at 0)
struct Dims {
  int B, A, TM, C, RC, SG, group, lanes;
  int o_act, o_tim, o_chd, o_rc, o_sg;
};

// int32 addition that wraps like the reference's int32 arithmetic
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block copies n int32 from src to shared dst (at a 16-byte
// boundary): 16-byte requests where src is 16-byte aligned, the tail and
// an unaligned src in 4-byte ones.
__device__ __forceinline__ void stage(int* dst, const int* src, int n) {
  const int t = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = t; i < n4; i += nt) cp_async16(dst + 4 * i, src + 4 * i);
    done = n4 << 2;
  }
  for (int i = done + t; i < n; i += nt) cp_async4(dst + i, src + i);
}

// A timer candidate: the least (expiry, id) seen, the max attempt and
// version over the slots that share it, and how many slots do.
struct Cand {
  int exp, id, att, ver, n;
};

__device__ __forceinline__ Cand no_cand() {
  return Cand{BIG, BIG, INT_MIN, INT_MIN, 0};
}

// Folds (exp, id, att, ver) of n slots into a. Commutative and
// associative, so the group's shuffles leave every thread the same result.
__device__ __forceinline__ void fold(Cand& a, int exp, int id, int att,
                                     int ver, int n) {
  if (exp < a.exp || (exp == a.exp && id < a.id)) {
    a = Cand{exp, id, att, ver, n};
  } else if (exp == a.exp && id == a.id) {
    a.att = max(a.att, att);
    a.ver = max(a.ver, ver);
    a.n += n;
  }
}

// An armed slot's candidate; an expiry of INT32_MAX is no candidate.
__device__ __forceinline__ void offer(Cand& a, bool armed, int exp, int id,
                                      int att, int ver) {
  if (armed && exp != BIG) fold(a, exp, id, att, ver, 1);
}

// Every thread of a group of g (a power of two) gets the group's fold.
__device__ __forceinline__ void group_fold(Cand& a, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) {
    const int exp = __shfl_xor_sync(FULL, a.exp, off);
    const int id = __shfl_xor_sync(FULL, a.id, off);
    const int att = __shfl_xor_sync(FULL, a.att, off);
    const int ver = __shfl_xor_sync(FULL, a.ver, off);
    const int n = __shfl_xor_sync(FULL, a.n, off);
    fold(a, exp, id, att, ver, n);
  }
}

__device__ __forceinline__ int group_max(int v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Attempt and version of a kind's winner among `slots` slots, as the
// eager version's masked max over every slot reads them: where the least
// id is INT32_MAX every slot wins; attempt counts 0 from each slot that
// does not win.
__device__ __forceinline__ void winner_att_ver(const Cand& c, int slots,
                                               int all_att, int all_ver,
                                               int* att, int* ver) {
  if (c.id == BIG) {
    *att = all_att;
    *ver = all_ver;
  } else {
    *att = c.n < slots ? max(c.att, 0) : c.att;
    *ver = c.ver;
  }
}

__global__ void refresh_kernel(Tables in, Outs out, Dims d) {
  extern __shared__ __align__(16) int smem[];
  const int L = d.lanes;
  const long long b0 = (long long)blockIdx.x * L;
  const int nl = (int)min((long long)L, (long long)d.B - b0);

  const int w_act = d.A * AC_N, w_tim = d.TM * TI_N, w_chd = d.C * CH_N;
  const int w_rc = d.RC * EXT_N, w_sg = d.SG * EXT_N;
  int* s_ex = smem;
  int* s_act = smem + d.o_act;
  int* s_tim = smem + d.o_tim;
  int* s_chd = smem + d.o_chd;
  int* s_rc = smem + d.o_rc;
  int* s_sg = smem + d.o_sg;
  stage(s_ex, in.ex + b0 * X_N, nl * X_N);
  stage(s_act, in.act + b0 * w_act, nl * w_act);
  stage(s_tim, in.tim + b0 * w_tim, nl * w_tim);
  stage(s_chd, in.chd + b0 * w_chd, nl * w_chd);
  stage(s_rc, in.rc + b0 * w_rc, nl * w_rc);
  stage(s_sg, in.sg + b0 * w_sg, nl * w_sg);
  cp_async_wait_all();
  __syncthreads();

  // a lane past the batch computes on what its slab holds and writes
  // nothing: every thread of a warp takes part in the shuffles
  const int g = d.group;
  const int lane = threadIdx.x / g;
  const int j = threadIdx.x % g;
  const bool valid = lane < nl;
  const long long b = b0 + lane;

  const int* x = s_ex + lane * X_N;
  const int wf_state = x[X_STATE];
  const bool running = wf_state == WF_CREATED || wf_state == WF_RUNNING;
  const int dec_sid = x[X_DEC_SCHEDULE_ID];
  const bool pending_dec = running && dec_sid != EMPTY_EVENT_ID;
  const bool inflight = pending_dec && x[X_DEC_STARTED_ID] > 0;

  // activity slots: the transfers, and each kind's timer candidate in
  // the order (timeout type, the reference's kind order): StartToClose,
  // ScheduleToStart and ScheduleToClose of an unstarted slot, then of a
  // started one, Heartbeat. Position p has timeout type p - (p >= 3).
  Cand kind[N_KINDS];
#pragma unroll
  for (int p = 0; p < N_KINDS; ++p) kind[p] = no_cand();
  int all_att = INT_MIN, all_ver = INT_MIN;
  for (int s = j; s < d.A; s += g) {
    const int* r = s_act + (lane * d.A + s) * AC_N;
    const bool occ = r[AC_OCC] > 0;
    const bool unstarted = occ && r[AC_STARTED_ID] == EMPTY_EVENT_ID;
    const bool started = occ && r[AC_STARTED_ID] != EMPTY_EVENT_ID;
    const int sid = r[AC_SCHEDULE_ID], att = r[AC_ATTEMPT];
    const int ver = r[AC_VERSION];
    all_att = max(all_att, att);
    all_ver = max(all_ver, ver);
    if (valid)
      out.activity_transfer[b * d.A + s] = unstarted && running ? sid : -1;
    if (running) {
      const int sched = r[AC_SCHEDULED_TS], s2s = r[AC_SCH_TO_START];
      const int s2c = r[AC_SCH_TO_CLOSE], st2c = r[AC_START_TO_CLOSE];
      const int hb = r[AC_HEARTBEAT];
      offer(kind[0], started && st2c > 0, wadd(r[AC_STARTED_TS], st2c), sid,
            att, ver);
      offer(kind[1], unstarted && s2s > 0, wadd(sched, s2s), sid, att, ver);
      offer(kind[2], unstarted && s2c > 0, wadd(sched, s2c), sid, att, ver);
      offer(kind[3], started && s2c > 0, wadd(sched, s2c), sid, att, ver);
      offer(kind[4], started && hb > 0, wadd(r[AC_LAST_HB_TS], hb), sid, att,
            ver);
    }
  }
#pragma unroll
  for (int p = 0; p < N_KINDS; ++p) group_fold(kind[p], g);
  all_att = group_max(all_att, g);
  all_ver = group_max(all_ver, g);
  // across kinds: the least (expiry, schedule id), then the first position
  int first = -1;
  Cand best = no_cand();
#pragma unroll
  for (int p = 0; p < N_KINDS; ++p) {
    const Cand& c = kind[p];
    if (c.exp < best.exp || (c.exp == best.exp && c.id < best.id)) {
      best = c;
      first = p;
    }
  }
  int a_row[5] = {-1, -1, -1, -1, -1};
  if (first >= 0) {
    a_row[0] = best.exp;
    a_row[1] = first - (first >= 3);
    a_row[2] = best.id;
    winner_att_ver(best, d.A, all_att, all_ver, &a_row[3], &a_row[4]);
  }

  // the user timer: the least (expiry, started id) of a running lane's
  // occupied timers, version the max over the tied winners
  Cand u = no_cand();
  int all_tver = INT_MIN;
  for (int s = j; s < d.TM; s += g) {
    const int* r = s_tim + (lane * d.TM + s) * TI_N;
    all_tver = max(all_tver, r[TI_VERSION]);
    offer(u, running && r[TI_OCC] > 0, r[TI_EXPIRY_TS], r[TI_STARTED_ID], 0,
          r[TI_VERSION]);
  }
  group_fold(u, g);
  all_tver = group_max(all_tver, g);
  int u_row[3] = {-1, -1, -1};
  if (u.exp != BIG) {
    u_row[0] = u.exp;
    u_row[1] = u.id;
    u_row[2] = u.id == BIG ? all_tver : u.ver;
  }

  if (!valid) return;
  for (int s = j; s < d.C; s += g) {
    const int* r = s_chd + (lane * d.C + s) * CH_N;
    const bool pending = running && r[CH_OCC] > 0 &&
                         r[CH_STARTED_ID] == EMPTY_EVENT_ID;
    out.child_transfer[b * d.C + s] = pending ? r[CH_INITIATED_ID] : -1;
  }
  for (int s = j; s < d.RC; s += g) {
    const int* r = s_rc + (lane * d.RC + s) * EXT_N;
    out.cancel_transfer[b * d.RC + s] =
        running && r[EXT_OCC] > 0 ? r[EXT_INITIATED_ID] : -1;
  }
  for (int s = j; s < d.SG; s += g) {
    const int* r = s_sg + (lane * d.SG + s) * EXT_N;
    out.signal_transfer[b * d.SG + s] =
        running && r[EXT_OCC] > 0 ? r[EXT_INITIATED_ID] : -1;
  }
  // the rows by component (constant indices once unrolled: no local
  // memory for the row arrays)
#pragma unroll
  for (int c = 0; c < 5; ++c)
    if (c % g == j) out.activity_timer[b * 5 + c] = a_row[c];
  const int d_row[3] = {wadd(x[X_DEC_STARTED_TS], x[X_DEC_TIMEOUT]), dec_sid,
                        x[X_DEC_ATTEMPT]};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c % g == j) {
      out.user_timer[b * 3 + c] = u_row[c];
      out.decision_timer[b * 3 + c] = inflight ? d_row[c] : -1;
    }
  }
  if (j == 0) {
    out.close_transfer[b] = running ? 0 : 1;
    out.workflow_timeout_ts[b] =
        running ? wadd(x[X_START_TS], x[X_WORKFLOW_TIMEOUT]) : -1;
    out.decision_transfer[b] = pending_dec ? dec_sid : -1;
    out.first_decision_pending[b] = running && dec_sid == EMPTY_EVENT_ID &&
                                    x[X_LAST_PROCESSED_EVENT] < 1;
    out.start_ts[b] = x[X_START_TS];
  }
}

// the largest dynamic shared memory the kernel was allowed, by device
constexpr int MAX_DEVICES = 64;
int smem_allowed[MAX_DEVICES];

}  // namespace

extern "C" {

// Refreshes the tasks of B lanes: the six int32 tables in, the 12 output
// arrays (RefreshedTasks' fields, in order; the two bool ones one byte a
// lane) out, every array contiguous on `device`. A, TM, C, RC, SG: the
// tables' slot counts; group, lanes: threads a lane and lanes a block;
// o_*: the slabs' int32 offsets in shared memory and smem_ints their end
// (ops/refresh.py refresh_plan, which checks them). Returns a cudaError_t.
int cadence_refresh_tasks(
    const int* exec_info, const int* activities, const int* timers,
    const int* children, const int* cancels, const int* signals,
    unsigned char* close_transfer, int* workflow_timeout_ts,
    int* decision_transfer, int* decision_timer, int* activity_transfer,
    int* activity_timer, int* user_timer, int* child_transfer,
    int* cancel_transfer, int* signal_transfer,
    unsigned char* first_decision_pending, int* start_ts, int B, int A,
    int TM, int C, int RC, int SG, int group, int lanes, int o_act,
    int o_tim, int o_chd, int o_rc, int o_sg, int smem_ints, void* stream,
    int device) {
  const Dims d{B, A, TM, C, RC, SG, group, lanes,
               o_act, o_tim, o_chd, o_rc, o_sg};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  const int smem = 4 * smem_ints;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (smem > smem_allowed[device]) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(refresh_kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed[device] = smem;
  }
  const Tables in{exec_info, activities, timers, children, cancels, signals};
  const Outs out{close_transfer,   workflow_timeout_ts, decision_transfer,
                 decision_timer,   activity_transfer,   activity_timer,
                 user_timer,       child_transfer,      cancel_transfer,
                 signal_transfer,  first_decision_pending, start_ts};
  const unsigned grid = (unsigned)((B + (long long)lanes - 1) / lanes);
  refresh_kernel<<<grid, lanes * group, (size_t)smem,
                   static_cast<cudaStream_t>(stream)>>>(in, out, d);
  return (int)cudaGetLastError();
}

const char* cadence_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
