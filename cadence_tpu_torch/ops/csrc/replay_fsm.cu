// Batched workflow-history replay: the event-sourced FSM, one thread per
// history lane, for Hopper (sm_90a).
//
// Replaces cadence_tpu/ops/replay_pallas.py::_kernel (launched by
// _replay_rows_pallas_jit), the reference's stateBuilder.applyEvents
// transition table, and the packed route's between-block flush of
// replay_scan_pallas_packed (_packed_scan_core). Same inputs give the same
// state, bit for bit.
//
// What bounds it on this card: streaming the event tensor from device
// memory, and issuing the transition code. Each lane-step reads one event
// (16 int32 fields, or 16 to 32 int16 columns of the narrow stream); the
// state is read once and written once per launch (R_pad x 4 bytes per
// lane against T x 64 bytes of int32 events). The state tile costs
// 4 x (R_pad - 26) bytes of shared memory per lane (504 B at the
// retry_deep caps), so only about 8 warps fit an SM: the event stream has
// to stay in flight without many warps, and those few warps spend their
// issue slots on the switch's divergent paths (the lanes of a warp replay
// different histories, so one step runs several event types' code): on
// the int16 stream, whose bytes take less time, that issue time bounds
// the kernel (testing/kernel_ablate.py times it).
//
// What the design does about it:
// - every warp keeps a private ring of STAGES stages in shared memory,
//   each holding the [P][32] event tiles of `ksteps` consecutive steps of
//   its 32 lanes. The warp's threads fill a stage together with cp.async
//   requests of 16 bytes (narrower only where the batch width or the
//   base address is not 16-byte aligned; int16 at an odd width falls
//   back to 2-byte loads), and STAGES - 1 stages are in flight while one
//   applies. The bytes in flight no longer depend on registers or on the
//   width of a field. The rings are per warp, so warps wait on their own
//   copies (cp.async.wait_group + __syncwarp) and never on each other;
// - the launcher takes the deepest ring that keeps the launch at its
//   fewest rounds of resident blocks: a warp's 1,024 steps run in order,
//   so the rounds set the time, and within them a deeper ring hides more
//   memory latency and pays its per-stage wait less often;
// - events are field-major [T, P, B] with the lane minor, so a stage is
//   ksteps * P rows of 32 lanes: every request is coalesced, and each
//   thread reads its fields from shared memory lane-minor, free of bank
//   conflicts. int16 values are widened when read, before any arithmetic
//   (affine columns rebuild as v16 + base[c], wide ones as
//   (lo & 0xffff) | hi << 16);
// - the 25 exec-info rows, which every step's preamble writes at fixed
//   indices, the version history's length and its last version live in
//   registers; the version-history items and the slot tables, indexed by
//   data, live in the warp's shared tile [R_pad - 26][32] int32, so every
//   row offset inside a table is an immediate. Slot tables are indexed
//   directly by EV_SLOT, bounds-checked: a slot of -1 or >= cap writes
//   nothing;
// - the sequential time axis of the TPU grid is a loop inside the thread,
//   and a switch on the event type replaces the TPU's per-group presence
//   bitmasks. The groups apply in the reference order: the preamble, then
//   the version history, then the type's group, which reads what the
//   preamble wrote (decision fail/timeout reads X_CUR_VERSION);
// - the lane-packed route runs in the same launch: each lane walks its own
//   list of segment ends (end step, output column, reset column). At an
//   end step the thread writes its state column to the output column and
//   reloads it from the reset column of init_rows; a column out of range
//   writes nothing. The TPU kernel cannot scatter across lanes, so its
//   packed route flushes between 16-step launches; here one launch covers
//   every step and segments need no alignment.
//
// Row offsets and capacities are runtime parameters, so one build serves
// every Capacities. The launch allocates nothing, runs on the caller's
// stream and returns a cudaError_t; the Python wrapper (ops/replay_cuda.py)
// raises on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// ---- schema constants (ops/schema.py)
enum Ev {
  EV_TYPE = 0, EV_ID = 1, EV_VERSION = 2, EV_TASK_ID = 3, EV_TS = 4,
  EV_BATCH_FIRST = 5, EV_IS_BATCH_LAST = 6, EV_SLOT = 7, EV_A0 = 8,
  EV_A1 = 9, EV_A2 = 10, EV_A3 = 11, EV_A4 = 12, EV_A5 = 13, EV_A6 = 14,
  EV_A7 = 15, EV_N = 16
};
enum Exec {
  X_STATE = 0, X_CLOSE_STATUS = 1, X_NEXT_EVENT_ID = 2,
  X_LAST_FIRST_EVENT_ID = 3, X_LAST_EVENT_TASK_ID = 4,
  X_LAST_PROCESSED_EVENT = 5, X_START_TS = 6, X_WORKFLOW_TIMEOUT = 7,
  X_DECISION_TIMEOUT_VALUE = 8, X_DEC_VERSION = 9, X_DEC_SCHEDULE_ID = 10,
  X_DEC_STARTED_ID = 11, X_DEC_TIMEOUT = 12, X_DEC_ATTEMPT = 13,
  X_DEC_SCHEDULED_TS = 14, X_DEC_STARTED_TS = 15,
  X_DEC_ORIGINAL_SCHEDULED_TS = 16, X_CANCEL_REQUESTED = 17,
  X_SIGNAL_COUNT = 18, X_ATTEMPT = 19, X_HAS_RETRY_POLICY = 20,
  X_COMPLETION_EVENT_BATCH_ID = 21, X_PARENT_INITIATED_ID = 22,
  X_WF_EXPIRATION_TS = 23, X_CUR_VERSION = 24, X_ROWS = 25
};
enum Act {
  AC_OCC = 0, AC_VERSION = 1, AC_SCHEDULE_ID = 2, AC_SCHEDULED_BATCH_ID = 3,
  AC_SCHEDULED_TS = 4, AC_STARTED_ID = 5, AC_STARTED_TS = 6, AC_ID_HASH = 7,
  AC_SCH_TO_START = 8, AC_SCH_TO_CLOSE = 9, AC_START_TO_CLOSE = 10,
  AC_HEARTBEAT = 11, AC_CANCEL_REQUESTED = 12, AC_CANCEL_REQUEST_ID = 13,
  AC_ATTEMPT = 14, AC_HAS_RETRY = 15, AC_EXPIRATION_TS = 16,
  AC_LAST_HB_TS = 17, AC_TIMER_STATUS = 18, AC_N = 19
};
enum Tim {
  TI_OCC = 0, TI_VERSION = 1, TI_STARTED_ID = 2, TI_ID_HASH = 3,
  TI_EXPIRY_TS = 4, TI_STATUS = 5, TI_N = 6
};
enum Chd {
  CH_OCC = 0, CH_VERSION = 1, CH_INITIATED_ID = 2, CH_INITIATED_BATCH_ID = 3,
  CH_STARTED_ID = 4, CH_WF_ID_HASH = 5, CH_RUN_ID_HASH = 6, CH_POLICY = 7,
  CH_N = 8
};
// external cancels and signals share one column layout:
// occupied, version, initiated id, initiated batch id
enum Ext { EXT_N = 4 };

// ---- core/ids.py sentinels and core/enums.py codes
constexpr int EMPTY_EVENT_ID = -23;
constexpr int EMPTY_VERSION = -24;
constexpr int WF_CREATED = 0, WF_RUNNING = 1, WF_COMPLETED = 2;
constexpr int CS_COMPLETED = 1, CS_FAILED = 2, CS_CANCELED = 3,
              CS_TERMINATED = 4, CS_CONTINUED_AS_NEW = 5, CS_TIMED_OUT = 6;
constexpr int TIMEOUT_SCHEDULE_TO_START = 1;

enum EventType {
  WorkflowExecutionStarted = 0, WorkflowExecutionCompleted = 1,
  WorkflowExecutionFailed = 2, WorkflowExecutionTimedOut = 3,
  DecisionTaskScheduled = 4, DecisionTaskStarted = 5,
  DecisionTaskCompleted = 6, DecisionTaskTimedOut = 7,
  DecisionTaskFailed = 8, ActivityTaskScheduled = 9,
  ActivityTaskStarted = 10, ActivityTaskCompleted = 11,
  ActivityTaskFailed = 12, ActivityTaskTimedOut = 13,
  ActivityTaskCancelRequested = 14, RequestCancelActivityTaskFailed = 15,
  ActivityTaskCanceled = 16, TimerStarted = 17, TimerFired = 18,
  CancelTimerFailed = 19, TimerCanceled = 20,
  WorkflowExecutionCancelRequested = 21, WorkflowExecutionCanceled = 22,
  RequestCancelExternalWorkflowExecutionInitiated = 23,
  RequestCancelExternalWorkflowExecutionFailed = 24,
  ExternalWorkflowExecutionCancelRequested = 25, MarkerRecorded = 26,
  WorkflowExecutionSignaled = 27, WorkflowExecutionTerminated = 28,
  WorkflowExecutionContinuedAsNew = 29,
  StartChildWorkflowExecutionInitiated = 30,
  StartChildWorkflowExecutionFailed = 31,
  ChildWorkflowExecutionStarted = 32, ChildWorkflowExecutionCompleted = 33,
  ChildWorkflowExecutionFailed = 34, ChildWorkflowExecutionCanceled = 35,
  ChildWorkflowExecutionTimedOut = 36,
  ChildWorkflowExecutionTerminated = 37,
  SignalExternalWorkflowExecutionInitiated = 38,
  SignalExternalWorkflowExecutionFailed = 39,
  ExternalWorkflowExecutionSignaled = 40
};

// Host parameter block, in the order ops/replay_cuda.py _kernel_params
// writes it. Row offsets are absolute rows of the [R, B] matrix;
// read_params rebases them to the warp's shared tile, which leaves out the
// rows kept in registers.
struct Params {
  int T, P, B, R, t0, t1, lanes;
  int exec0, vh0, vhlen, act0, tim0, chd0, rc0, sg0;
  int cap_a, cap_t, cap_c, cap_rc, cap_sg, cap_v;
  int wide_mask;
  int phys[EV_N];
  int base[EV_N];
};
constexpr int N_PARAMS = 22 + 2 * EV_N;
static_assert(sizeof(Params) == N_PARAMS * sizeof(int), "packed params");

// Ring depth per warp: STAGES - 1 stages in flight while one applies.
constexpr int STAGES = 3;
// The most steps one stage holds.
constexpr int MAX_KSTEPS = 16;
constexpr int WARP = 32;

// int32 addition that wraps like the reference's int32 arithmetic
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// ---- the event ring

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One request of VEC bytes from global src to shared dst.
template <int VEC, typename EvT>
__device__ __forceinline__ void copy_request(EvT* dst, const EvT* src) {
  if constexpr (VEC == 16) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(d), "l"(src) : "memory");
  } else if constexpr (VEC == 8 || VEC == 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 ::"r"(d), "l"(src), "n"(VEC) : "memory");
  } else {
    static_assert(VEC == (int)sizeof(EvT), "2-byte requests: int16 only");
    *dst = *src;  // an odd int16 width: plain loads, ordered by __syncwarp
  }
}

// The warp fills one stage: `nrows` consecutive [32]-lane rows of the
// field-major event tensor, starting at row `row0` of [T * P, B], into
// dst[nrows][32]. A request covers KE lanes; the batch width is a
// multiple of KE (the launcher chose VEC so), so a request lies wholly
// inside or wholly past the batch, and past it nothing is copied.
template <int VEC, typename EvT>
__device__ __forceinline__ void fill_rows(const EvT* __restrict__ ev,
                                          EvT* dst, size_t row0, int nrows,
                                          int B, int b_warp, int lane) {
  constexpr int KE = VEC / (int)sizeof(EvT);  // lanes per request
  constexpr int PER_ROW = WARP / KE;          // requests per row
  constexpr int RSTRIDE = WARP / PER_ROW;     // rows per pass of the warp
  const int q = lane % PER_ROW;
  const int r0 = lane / PER_ROW;
  const int lane0 = b_warp + q * KE;
  if (lane0 >= B) return;
  const size_t Bs = (size_t)B;
  const EvT* src = ev + (row0 + r0) * Bs + lane0;
  EvT* d = dst + r0 * WARP + q * KE;
  for (int r = r0; r < nrows; r += RSTRIDE) {
    copy_request<VEC>(d, src);
    src += RSTRIDE * Bs;
    d += RSTRIDE * WARP;
  }
}

template <typename EvT>
__device__ __forceinline__ void fill_stage(const EvT* __restrict__ ev,
                                           EvT* dst, size_t row0, int nrows,
                                           int B, int b_warp, int lane,
                                           int vec) {
  switch (vec) {
    case 16: fill_rows<16>(ev, dst, row0, nrows, B, b_warp, lane); break;
    case 8: fill_rows<8>(ev, dst, row0, nrows, B, b_warp, lane); break;
    case 4: fill_rows<4>(ev, dst, row0, nrows, B, b_warp, lane); break;
    default:
      if constexpr (sizeof(EvT) == 2)
        fill_rows<2>(ev, dst, row0, nrows, B, b_warp, lane);
      break;
  }
}

// The int32 fields of one step from its [P][32] tile (tile points at this
// lane's column). int16 values widen first: a wide column rebuilds as
// (lo & 0xffff) | hi << 16, an affine one as lo + base[c].
template <typename EvT>
__device__ __forceinline__ void read_fields(const EvT* tile, const Params& p,
                                            int (&f)[EV_N]) {
#pragma unroll
  for (int c = 0; c < EV_N; ++c) {
    if constexpr (sizeof(EvT) == 4) {
      f[c] = tile[c * WARP];
    } else {
      const int ph = p.phys[c];
      const int lo = (int)tile[ph * WARP];
      if ((p.wide_mask >> c) & 1) {
        const int hi = (int)tile[(ph + 1) * WARP];
        f[c] = (lo & 0xffff) | (int)((unsigned)hi << 16);
      } else {
        f[c] = wadd(lo, p.base[c]);
      }
    }
  }
}

// ---- the transition table

// A lane's state on chip: the exec rows, the version history's length
// and the version of its last materialized item in registers; the
// version-history items and the slot tables in the warp's shared tile.
struct Lane {
  int x[X_ROWS];
  int vh_len;
  int last_ver;
};

// Shared row r (rebased: rows past the exec rows, the vh_len row left
// out) of this lane: st[r * WARP], the warp's tile being [rs][32] with
// the lane offset folded into st by the caller.
#define SR(r) st[(r) * WARP]

// The version of the item AddOrUpdateItem reads: the last materialized
// one, its index clamped to the table (0 with no table).
__device__ __forceinline__ int last_version(const int* st, const Params& p,
                                            int vh_len) {
  const int read_idx = min(max(wadd(vh_len, -1), 0), p.cap_v - 1);
  return read_idx >= 0 ? SR(p.vh0 + 2 * read_idx + 1) : 0;
}

__device__ __forceinline__ void apply_step(Lane& s, int* st,
                                           const Params& p,
                                           const int (&f)[EV_N]) {
  int (&x)[X_ROWS] = s.x;
  const int et = f[EV_TYPE];
  if (et < 0) return;  // padding: no-op, preamble included
  const int ev_id = f[EV_ID];
  const int version = f[EV_VERSION];
  const int ts = f[EV_TS];
  const int bf = f[EV_BATCH_FIRST];
  const int slot = f[EV_SLOT];
  const int a0 = f[EV_A0], a1 = f[EV_A1], a2 = f[EV_A2], a3 = f[EV_A3];
  const int a4 = f[EV_A4], a5 = f[EV_A5], a6 = f[EV_A6], a7 = f[EV_A7];

  // ---- preamble (stateBuilder.go:134-155)
  x[X_LAST_EVENT_TASK_ID] = f[EV_TASK_ID];
  x[X_CUR_VERSION] = version;
  x[X_NEXT_EVENT_ID] = wadd(ev_id, 1);
  x[X_LAST_FIRST_EVENT_ID] = bf;

  // ---- version-history AddOrUpdateItem: the read clamps to the last
  // materialized slot; the write keeps the raw last index, so a
  // same-version write past capacity matches no slot. The read is the
  // cached s.last_ver: a new item is the next step's last one, and a
  // same-version write leaves it as it was; only when a new version
  // writes no slot (vh_len < 0, or no table) is it read again.
  {
    const int cap_v = p.cap_v;
    const int vh_len = s.vh_len;
    const bool same = vh_len > 0 && s.last_ver == version;
    const int write_idx = same ? max(wadd(vh_len, -1), 0)
                               : min(vh_len, cap_v - 1);
    const bool wrote = write_idx >= 0 && write_idx < cap_v;
    if (wrote) {
      SR(p.vh0 + 2 * write_idx) = ev_id;
      SR(p.vh0 + 2 * write_idx + 1) = version;
    }
    if (!same) {
      s.vh_len = wadd(vh_len, 1);
      s.last_ver = wrote ? version : last_version(st, p, s.vh_len);
    }
  }

  int close_status = 0;
  switch (et) {
    // ---- workflow lifecycle
    case WorkflowExecutionStarted:
      x[X_STATE] = WF_CREATED;
      x[X_CLOSE_STATUS] = 0;
      x[X_LAST_PROCESSED_EVENT] = EMPTY_EVENT_ID;
      x[X_START_TS] = ts;
      x[X_WORKFLOW_TIMEOUT] = a0;
      x[X_DECISION_TIMEOUT_VALUE] = a1;
      x[X_ATTEMPT] = a2;
      x[X_HAS_RETRY_POLICY] = a3;
      x[X_WF_EXPIRATION_TS] = a4;
      x[X_PARENT_INITIATED_ID] = a7;
      x[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
      x[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
      x[X_DEC_VERSION] = EMPTY_VERSION;
      x[X_DEC_TIMEOUT] = 0;
      x[X_DEC_ATTEMPT] = 0;
      x[X_DEC_SCHEDULED_TS] = 0;
      x[X_DEC_STARTED_TS] = 0;
      x[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
      break;
    case WorkflowExecutionCompleted: close_status = CS_COMPLETED; break;
    case WorkflowExecutionFailed: close_status = CS_FAILED; break;
    case WorkflowExecutionTimedOut: close_status = CS_TIMED_OUT; break;
    case WorkflowExecutionCanceled: close_status = CS_CANCELED; break;
    case WorkflowExecutionTerminated: close_status = CS_TERMINATED; break;
    case WorkflowExecutionContinuedAsNew:
      close_status = CS_CONTINUED_AS_NEW;
      break;
    case WorkflowExecutionCancelRequested:
      x[X_CANCEL_REQUESTED] = 1;
      break;
    case WorkflowExecutionSignaled:
      x[X_SIGNAL_COUNT] = wadd(x[X_SIGNAL_COUNT], 1);
      break;

    // ---- decision sub-FSM
    case DecisionTaskScheduled:
      x[X_DEC_VERSION] = version;
      x[X_DEC_SCHEDULE_ID] = ev_id;
      x[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
      x[X_DEC_TIMEOUT] = a0;
      x[X_DEC_ATTEMPT] = a1;
      x[X_DEC_SCHEDULED_TS] = ts;
      x[X_DEC_ORIGINAL_SCHEDULED_TS] = ts;
      x[X_DEC_STARTED_TS] = 0;
      break;
    case DecisionTaskStarted:
      if (x[X_STATE] == WF_CREATED) x[X_STATE] = WF_RUNNING;
      x[X_DEC_VERSION] = version;
      x[X_DEC_STARTED_ID] = ev_id;
      x[X_DEC_ATTEMPT] = 0;
      x[X_DEC_STARTED_TS] = ts;
      break;
    case DecisionTaskCompleted:
      x[X_DEC_VERSION] = EMPTY_VERSION;
      x[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
      x[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
      x[X_DEC_TIMEOUT] = 0;
      x[X_DEC_ATTEMPT] = 0;
      x[X_DEC_SCHEDULED_TS] = 0;
      x[X_DEC_STARTED_TS] = 0;
      x[X_LAST_PROCESSED_EVENT] = a0;
      break;
    case DecisionTaskTimedOut:
    case DecisionTaskFailed: {
      const bool inc = et == DecisionTaskFailed ||
                       a0 != TIMEOUT_SCHEDULE_TO_START;
      if (inc) {
        const int new_attempt = wadd(x[X_DEC_ATTEMPT], 1);
        x[X_DEC_VERSION] = x[X_CUR_VERSION];
        x[X_DEC_SCHEDULE_ID] = bf;
        x[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
        x[X_DEC_TIMEOUT] = x[X_DECISION_TIMEOUT_VALUE];
        x[X_DEC_ATTEMPT] = new_attempt;
        x[X_DEC_SCHEDULED_TS] = ts;
        x[X_DEC_STARTED_TS] = 0;
        x[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
      } else {
        x[X_DEC_VERSION] = EMPTY_VERSION;
        x[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
        x[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
        x[X_DEC_TIMEOUT] = 0;
        x[X_DEC_ATTEMPT] = 0;
        x[X_DEC_SCHEDULED_TS] = 0;
        x[X_DEC_STARTED_TS] = 0;
        x[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
      }
      break;
    }

    // ---- pending activities
    case ActivityTaskScheduled:
      if ((unsigned)slot < (unsigned)p.cap_a) {
        const int r = p.act0 + slot * AC_N;
        const int exp_interval = (a5 > 0 && a6 > a2) ? a6 : a2;
        SR(r + AC_OCC) = 1;
        SR(r + AC_VERSION) = version;
        SR(r + AC_SCHEDULE_ID) = ev_id;
        SR(r + AC_SCHEDULED_BATCH_ID) = bf;
        SR(r + AC_SCHEDULED_TS) = ts;
        SR(r + AC_STARTED_ID) = EMPTY_EVENT_ID;
        SR(r + AC_STARTED_TS) = 0;
        SR(r + AC_ID_HASH) = a0;
        SR(r + AC_SCH_TO_START) = a1;
        SR(r + AC_SCH_TO_CLOSE) = a2;
        SR(r + AC_START_TO_CLOSE) = a3;
        SR(r + AC_HEARTBEAT) = a4;
        SR(r + AC_CANCEL_REQUESTED) = 0;
        SR(r + AC_CANCEL_REQUEST_ID) = EMPTY_EVENT_ID;
        SR(r + AC_ATTEMPT) = 0;
        SR(r + AC_HAS_RETRY) = a5;
        SR(r + AC_EXPIRATION_TS) = wadd(ts, exp_interval);
        SR(r + AC_LAST_HB_TS) = 0;
        SR(r + AC_TIMER_STATUS) = 0;
      }
      break;
    case ActivityTaskStarted:
      if ((unsigned)slot < (unsigned)p.cap_a) {
        const int r = p.act0 + slot * AC_N;
        SR(r + AC_VERSION) = version;
        SR(r + AC_STARTED_ID) = ev_id;
        SR(r + AC_STARTED_TS) = ts;
        SR(r + AC_LAST_HB_TS) = ts;
        SR(r + AC_ATTEMPT) = a1;
      }
      break;
    case ActivityTaskCompleted:
    case ActivityTaskFailed:
    case ActivityTaskTimedOut:
    case ActivityTaskCanceled:
      if ((unsigned)slot < (unsigned)p.cap_a) {
        const int r = p.act0 + slot * AC_N;
#pragma unroll
        for (int c = 0; c < AC_N; ++c) SR(r + c) = 0;
      }
      break;
    case ActivityTaskCancelRequested:
      if ((unsigned)slot < (unsigned)p.cap_a) {
        const int r = p.act0 + slot * AC_N;
        SR(r + AC_VERSION) = version;
        SR(r + AC_CANCEL_REQUESTED) = 1;
        SR(r + AC_CANCEL_REQUEST_ID) = ev_id;
      }
      break;

    // ---- pending timers
    case TimerStarted:
      if ((unsigned)slot < (unsigned)p.cap_t) {
        const int r = p.tim0 + slot * TI_N;
        SR(r + TI_OCC) = 1;
        SR(r + TI_VERSION) = version;
        SR(r + TI_STARTED_ID) = ev_id;
        SR(r + TI_ID_HASH) = a0;
        SR(r + TI_EXPIRY_TS) = wadd(ts, a1);
        SR(r + TI_STATUS) = 0;
      }
      break;
    case TimerFired:
    case TimerCanceled:
      if ((unsigned)slot < (unsigned)p.cap_t) {
        const int r = p.tim0 + slot * TI_N;
#pragma unroll
        for (int c = 0; c < TI_N; ++c) SR(r + c) = 0;
      }
      break;

    // ---- pending children
    case StartChildWorkflowExecutionInitiated:
      if ((unsigned)slot < (unsigned)p.cap_c) {
        const int r = p.chd0 + slot * CH_N;
        SR(r + CH_OCC) = 1;
        SR(r + CH_VERSION) = version;
        SR(r + CH_INITIATED_ID) = ev_id;
        SR(r + CH_INITIATED_BATCH_ID) = bf;
        SR(r + CH_STARTED_ID) = EMPTY_EVENT_ID;
        SR(r + CH_WF_ID_HASH) = a0;
        SR(r + CH_RUN_ID_HASH) = 0;
        SR(r + CH_POLICY) = a1;
      }
      break;
    case ChildWorkflowExecutionStarted:
      if ((unsigned)slot < (unsigned)p.cap_c) {
        const int r = p.chd0 + slot * CH_N;
        SR(r + CH_STARTED_ID) = ev_id;
        SR(r + CH_RUN_ID_HASH) = a1;
      }
      break;
    case StartChildWorkflowExecutionFailed:
    case ChildWorkflowExecutionCompleted:
    case ChildWorkflowExecutionFailed:
    case ChildWorkflowExecutionCanceled:
    case ChildWorkflowExecutionTimedOut:
    case ChildWorkflowExecutionTerminated:
      if ((unsigned)slot < (unsigned)p.cap_c) {
        const int r = p.chd0 + slot * CH_N;
#pragma unroll
        for (int c = 0; c < CH_N; ++c) SR(r + c) = 0;
      }
      break;

    // ---- pending external cancels / signals
    case RequestCancelExternalWorkflowExecutionInitiated:
    case SignalExternalWorkflowExecutionInitiated: {
      const bool rc = et == RequestCancelExternalWorkflowExecutionInitiated;
      if ((unsigned)slot < (unsigned)(rc ? p.cap_rc : p.cap_sg)) {
        const int r = (rc ? p.rc0 : p.sg0) + slot * EXT_N;
        SR(r + 0) = 1;
        SR(r + 1) = version;
        SR(r + 2) = ev_id;
        SR(r + 3) = bf;
      }
      break;
    }
    case RequestCancelExternalWorkflowExecutionFailed:
    case ExternalWorkflowExecutionCancelRequested:
    case SignalExternalWorkflowExecutionFailed:
    case ExternalWorkflowExecutionSignaled: {
      const bool rc = et == RequestCancelExternalWorkflowExecutionFailed ||
                      et == ExternalWorkflowExecutionCancelRequested;
      if ((unsigned)slot < (unsigned)(rc ? p.cap_rc : p.cap_sg)) {
        const int r = (rc ? p.rc0 : p.sg0) + slot * EXT_N;
#pragma unroll
        for (int c = 0; c < EXT_N; ++c) SR(r + c) = 0;
      }
      break;
    }
    default:  // marker, search-attribute upsert, failed cancels: no group
      break;
  }
  if (close_status) {
    x[X_STATE] = WF_COMPLETED;
    x[X_CLOSE_STATUS] = close_status;
    x[X_COMPLETION_EVENT_BATCH_ID] = bf;
  }
}

// Column `col` of a [R, n] int32 matrix <-> this lane's state. Matrix
// row X_ROWS + r is shared row r, but for the vh_len row (p.vhlen, kept
// in a register), which shifts the rows after it down by one.
__device__ __forceinline__ int matrix_row(const Params& p, int r) {
  return X_ROWS + r + (r >= p.vhlen ? 1 : 0);
}

__device__ __forceinline__ void load_column(Lane& s, int* st,
                                            const Params& p, int rs,
                                            const int* m, size_t n,
                                            size_t col) {
#pragma unroll
  for (int c = 0; c < X_ROWS; ++c) s.x[c] = m[c * n + col];
  for (int r = 0; r < rs; ++r) SR(r) = m[matrix_row(p, r) * n + col];
  s.vh_len = m[(X_ROWS + p.vhlen) * n + col];
  s.last_ver = last_version(st, p, s.vh_len);
}

__device__ __forceinline__ void store_column(const Lane& s, const int* st,
                                             const Params& p, int rs,
                                             int* m, size_t n, size_t col) {
#pragma unroll
  for (int c = 0; c < X_ROWS; ++c) m[c * n + col] = s.x[c];
  for (int r = 0; r < rs; ++r) m[matrix_row(p, r) * n + col] = SR(r);
  m[(X_ROWS + p.vhlen) * n + col] = s.vh_len;
}

#undef SR

// Segment ends of the packed route: lane b's entries are
// segs[seg_ptr[b] : seg_ptr[b + 1]], each (end step, output column,
// reset column), by end step. out_rows [R, n_out]; init_rows [R, n_init].
struct Segments {
  const int* ptr;
  const int* ends;
  int* out_rows;
  const int* init_rows;
  int n_out, n_init;
};

template <typename EvT>
__global__ void __launch_bounds__(128)
replay_fsm_kernel(const EvT* __restrict__ ev, const int* rows_in,
                  int* rows_out, const Segments sg, const Params p,
                  int ksteps, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int b_warp = (blockIdx.x * warps + warp) * WARP;
  if (b_warp >= p.B) return;  // the whole warp lies past the batch
  const int b = b_warp + lane;
  const bool live = b < p.B;
  const size_t B = (size_t)p.B;
  const int rs = p.R - X_ROWS - 1;

  // shared memory: each warp's state tile [rs][32], then each warp's
  // event ring [STAGES][ksteps * P][32]
  int* st = reinterpret_cast<int*>(smem) + (size_t)warp * rs * WARP + lane;
  const int stage_elems = ksteps * p.P * WARP;
  EvT* ring = reinterpret_cast<EvT*>(smem + (size_t)warps * rs * WARP * 4) +
              (size_t)warp * STAGES * stage_elems;

  Lane ls;
  if (live) {
    load_column(ls, st, p, rs, rows_in, B, b);
  } else {
#pragma unroll
    for (int c = 0; c < X_ROWS; ++c) ls.x[c] = 0;
    ls.vh_len = ls.last_ver = 0;
  }

  // this lane's next segment end inside the window (none: INT_MAX)
  int seg = 0, seg_last = 0, next_end = INT_MAX;
  if (sg.ptr != nullptr && live) {
    seg = sg.ptr[b];
    seg_last = sg.ptr[b + 1];
    while (seg < seg_last && sg.ends[3 * seg] < p.t0) ++seg;
    if (seg < seg_last) next_end = sg.ends[3 * seg];
  }

  const int nstages = (p.t1 - p.t0 + ksteps - 1) / ksteps;
  auto fill = [&](int s) {
    const int t = p.t0 + s * ksteps;
    const int nk = min(ksteps, p.t1 - t);
    fill_stage(ev, ring + (s % STAGES) * stage_elems, (size_t)t * p.P,
               nk * p.P, p.B, b_warp, lane, vec);
  };
  // one commit group per stage, empty past the window, so that
  // wait_group<STAGES - 2> always means "stage s has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstages) fill(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<STAGES - 2>();
    // every lane's copies of stage s are visible to the warp, and every
    // lane is done reading stage s - 1, which the next fill overwrites
    __syncwarp();
    if (s + STAGES - 1 < nstages) fill(s + STAGES - 1);
    cp_async_commit();
    const EvT* tile = ring + (s % STAGES) * stage_elems + lane;
    const int t_first = p.t0 + s * ksteps;
    const int nk = min(ksteps, p.t1 - t_first);
    for (int k = 0; k < nk; ++k) {
      if (!live) continue;
      int f[EV_N];
      read_fields<EvT>(tile + k * p.P * WARP, p, f);
      apply_step(ls, st, p, f);
      if (t_first + k == next_end) {
        // segment end: flush this lane's state, then reset it
        const int* e = sg.ends + 3 * seg;
        const int ocol = e[1], rcol = e[2];
        if ((unsigned)ocol < (unsigned)sg.n_out)
          store_column(ls, st, p, rs, sg.out_rows, (size_t)sg.n_out,
                       (size_t)ocol);
        if ((unsigned)rcol < (unsigned)sg.n_init)
          load_column(ls, st, p, rs, sg.init_rows, (size_t)sg.n_init,
                      (size_t)rcol);
        ++seg;
        next_end = seg < seg_last ? sg.ends[3 * seg] : INT_MAX;
      }
    }
  }
  cp_async_wait<0>();
  if (live) store_column(ls, st, p, rs, rows_out, B, b);
}

// Launch geometry of one call.
struct Plan {
  int lanes;     // threads (lanes) per block
  int ksteps;    // steps per ring stage
  int vec;       // bytes per copy request
  size_t smem;   // dynamic shared memory per block
  int blocks;    // blocks resident per SM
};

int device_attr(cudaDeviceAttr a, int device, int fallback) {
  int v = 0;
  return cudaDeviceGetAttribute(&v, a, device) == cudaSuccess ? v : fallback;
}

// vec: the widest request (16, 8, 4 or, int16 only, 2 bytes) that the
// base address and the row pitch B * elem both allow. ksteps: the deepest
// ring that keeps the launch at its fewest rounds of resident blocks. A
// warp runs its lanes' steps in order, so a launch takes as many rounds
// as the SMs need to hold all its blocks; within that count, fewer
// resident warps contend less for issue and a deeper ring keeps more
// steps in flight and pays its per-stage wait less often.
template <typename EvT>
cudaError_t make_plan(const void* events, const Params& p, int device,
                      Plan* out) {
  const int elem = (int)sizeof(EvT);
  int vec = 16;
  while (vec > elem && ((((size_t)p.B * elem) % vec) != 0 ||
                        (reinterpret_cast<uintptr_t>(events) % vec) != 0))
    vec /= 2;
  const int warps = p.lanes / WARP;
  const size_t state = (size_t)(p.R - X_ROWS - 1) * p.lanes * 4;
  const size_t step_w = (size_t)p.P * WARP * elem;
  const int sm_smem = device_attr(
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, device, 233472);
  const int blk_smem = device_attr(
      cudaDevAttrMaxSharedMemoryPerBlockOptin, device, 232448);
  const int reserved = device_attr(
      cudaDevAttrReservedSharedMemoryPerBlock, device, 1024);
  const int sms = device_attr(cudaDevAttrMultiProcessorCount, device, 132);
  auto smem_of = [&](int k) {
    return state + (size_t)warps * STAGES * k * step_w;
  };
  const long grid = (p.B + p.lanes - 1) / p.lanes;
  int k = 0;
  long rounds = LONG_MAX, blocks = 0;
  for (int kk = 1; kk <= MAX_KSTEPS && smem_of(kk) <= (size_t)blk_smem;
       ++kk) {
    const long fit = (long)(sm_smem / (smem_of(kk) + reserved));
    if (fit == 0) break;
    const long r = (grid + sms * fit - 1) / (sms * fit);
    if (r <= rounds) {  // rounds only grow with kk: the last tie wins
      rounds = r;
      k = kk;
      blocks = fit;
    }
  }
  if (k == 0) return cudaErrorInvalidValue;
  *out = Plan{p.lanes, k, vec, smem_of(k), (int)blocks};
  return cudaSuccess;
}

template <typename EvT>
cudaError_t launch(const void* events, const int* rows_in, int* rows_out,
                   const Segments& sg, const Params& p, int device,
                   cudaStream_t stream) {
  Plan pl;
  cudaError_t e = make_plan<EvT>(events, p, device, &pl);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(replay_fsm_kernel<EvT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(replay_fsm_kernel<EvT>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.B + p.lanes - 1) / p.lanes);
  replay_fsm_kernel<EvT><<<grid, p.lanes, pl.smem, stream>>>(
      static_cast<const EvT*>(events), rows_in, rows_out, sg, p, pl.ksteps,
      pl.vec);
  return cudaGetLastError();
}

// Copies the host parameter block, checks it, and rebases the row
// offsets past the exec rows (which the kernel keeps in registers).
int read_params(const int* hp, int n_params, int ev_int16, Params* p) {
  if (n_params != N_PARAMS) return (int)cudaErrorInvalidValue;
  int* dst = reinterpret_cast<int*>(p);
  for (int i = 0; i < N_PARAMS; ++i) dst[i] = hp[i];
  if (p->B <= 0 || p->lanes <= 0 || p->lanes > 128 || p->lanes % WARP ||
      p->exec0 != 0 || p->vh0 != X_ROWS || p->R <= X_ROWS ||
      p->t0 < 0 || p->t0 > p->t1 || p->t1 > p->T ||
      p->P != EV_N + (ev_int16 ? __builtin_popcount(p->wide_mask) : 0))
    return (int)cudaErrorInvalidValue;
  // the vh_len row follows the version-history items and precedes the
  // slot tables (ops/replay_cuda.py RowMap); it lives in a register
  if (p->vhlen != p->vh0 + 2 * p->cap_v || p->act0 != p->vhlen + 1)
    return (int)cudaErrorInvalidValue;
  p->vh0 -= X_ROWS;
  p->vhlen -= X_ROWS;
  p->act0 -= X_ROWS + 1;
  p->tim0 -= X_ROWS + 1;
  p->chd0 -= X_ROWS + 1;
  p->rc0 -= X_ROWS + 1;
  p->sg0 -= X_ROWS + 1;
  return 0;
}

}  // namespace

extern "C" {

// Replays steps [t0, t1) of events [T, P, B] (int32, or int16 when
// ev_int16) onto rows_in [R, B] int32, writing rows_out [R, B] (may alias
// rows_in). hp: the N_PARAMS ints of Params.
//
// Lane-packed route, when seg_ptr is not null: seg_ptr [B + 1] and
// seg_ends [n, 3] list each lane's segment ends (end step, output column,
// reset column), by lane and then by step. At an end step inside the
// window the lane's state is written to column `output` of out_rows
// [R, n_out] and then reloaded from column `reset` of init_rows
// [R, n_init]; a column out of range writes nothing.
//
// Returns a cudaError_t.
int cadence_replay_fsm(const void* events, int ev_int16, const int* rows_in,
                       int* rows_out, const int* seg_ptr,
                       const int* seg_ends, int* out_rows, int n_out,
                       const int* init_rows, int n_init, const int* hp,
                       int n_params, void* stream, int device) {
  Params p;
  int bad = read_params(hp, n_params, ev_int16, &p);
  if (bad) return bad;
  if (seg_ptr != nullptr && (n_out < 0 || n_init < 0))
    return (int)cudaErrorInvalidValue;
  const Segments sg{seg_ptr, seg_ends, out_rows, init_rows, n_out, n_init};
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = ev_int16 ? launch<int16_t>(events, rows_in, rows_out, sg, p, device, s)
               : launch<int32_t>(events, rows_in, rows_out, sg, p, device, s);
  return (int)e;
}

// The launch geometry cadence_replay_fsm would use for these arguments:
// out[0..4] = lanes per block, steps per ring stage, bytes per copy
// request, dynamic shared memory per block, blocks resident per SM.
// Returns a cudaError_t.
int cadence_replay_fsm_plan(const void* events, int ev_int16, const int* hp,
                            int n_params, int device, int* out) {
  Params p;
  int bad = read_params(hp, n_params, ev_int16, &p);
  if (bad) return bad;
  Plan pl;
  cudaError_t e = ev_int16 ? make_plan<int16_t>(events, p, device, &pl)
                           : make_plan<int32_t>(events, p, device, &pl);
  if (e != cudaSuccess) return (int)e;
  out[0] = pl.lanes;
  out[1] = pl.ksteps;
  out[2] = pl.vec;
  out[3] = (int)pl.smem;
  out[4] = pl.blocks;
  return 0;
}

const char* cadence_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
