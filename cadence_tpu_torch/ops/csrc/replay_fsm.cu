// Batched workflow-history replay: the event-sourced FSM, one thread per
// history lane.
//
// Replaces cadence_tpu/ops/replay_pallas.py::_kernel (launched by
// _replay_rows_pallas_jit), the reference's stateBuilder.applyEvents
// transition table. Same inputs give the same state, bit for bit.
//
// What bounds it: streaming the event tensor from device memory. Each
// lane-step reads one event (16 int32 fields, or the int16 narrow stream)
// and does a few dozen integer operations on state that stays on chip;
// state is read once and written once per launch (R_pad x 4 bytes per
// lane against T x 64 bytes of events).
//
// What the design does about it:
// - events are field-major [T, P, B] with the lane minor, so each field
//   load is coalesced across the warp, and the int16 narrow stream halves
//   the bytes (affine columns rebuild as int32(v16) + base[c], wide ones as
//   (lo & 0xffff) | hi << 16, widened before any arithmetic);
// - the fields of the next two steps are loaded into registers before the
//   current step applies, and int16 values are rebuilt only when their
//   step applies, so loads stay in flight across the FSM of a step;
// - the lane's state column sits in shared memory as [R_pad][lanes] int32
//   (lanes minor, free of bank conflicts), loaded once from rows[R_pad, B]
//   and written back once. Slot tables are indexed directly by EV_SLOT,
//   bounds-checked: a slot of -1 or >= cap writes nothing;
// - the sequential time axis of the TPU grid is a loop inside the thread,
//   and a switch on the event type replaces the TPU's per-group presence
//   bitmasks. The groups apply in the reference order: the preamble, then
//   the version history, then the type's group, which reads what the
//   preamble wrote (decision fail/timeout reads X_CUR_VERSION).
//
// Row offsets and capacities are runtime parameters, so one build serves
// every Capacities. The launch allocates nothing and returns
// cudaGetLastError(); the Python wrapper (ops/replay_cuda.py) raises on a
// non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

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
  X_WF_EXPIRATION_TS = 23, X_CUR_VERSION = 24
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
// writes it.
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

// int32 addition that wraps like the reference's int32 arithmetic
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// One step's event fields as loaded: int16 values sign-extended but not
// yet rebuilt, so that nothing waits on a load until the step applies
// (rebuilding right after the load would stall the thread on it).
struct Raw {
  int lo[EV_N];
  int hi[EV_N];  // int16 stream, wide columns only
};

template <typename EvT>
__device__ __forceinline__ void load_raw(const EvT* __restrict__ ev,
                                         const Params& p, int t, int b,
                                         Raw& r) {
  const size_t row = (size_t)t * p.P;
  const size_t B = (size_t)p.B;
  if constexpr (sizeof(EvT) == 4) {
#pragma unroll
    for (int c = 0; c < EV_N; ++c) r.lo[c] = ev[(row + c) * B + b];
  } else {
#pragma unroll
    for (int c = 0; c < EV_N; ++c) {
      const size_t ph = (size_t)p.phys[c];
      r.lo[c] = ev[(row + ph) * B + b];
      r.hi[c] = ((p.wide_mask >> c) & 1) ? (int)ev[(row + ph + 1) * B + b]
                                          : 0;
    }
  }
}

// The int32 fields of a loaded step: a wide column rebuilds as
// (lo & 0xffff) | hi << 16, an affine one as lo + base[c].
template <typename EvT>
__device__ __forceinline__ void decode(const Raw& r, const Params& p,
                                       int (&f)[EV_N]) {
#pragma unroll
  for (int c = 0; c < EV_N; ++c) {
    if constexpr (sizeof(EvT) == 4) {
      f[c] = r.lo[c];
    } else if ((p.wide_mask >> c) & 1) {
      f[c] = (r.lo[c] & 0xffff) | (int)((unsigned)r.hi[c] << 16);
    } else {
      f[c] = wadd(r.lo[c], p.base[c]);
    }
  }
}

// State row r of this lane: st[r * lanes] (the lane offset is folded
// into st by the caller).
#define SR(r) st[(r) * lanes]

__device__ __forceinline__ void apply_step(int* st, const int lanes,
                                           const Params& p,
                                           const int (&f)[EV_N]) {
  const int et = f[EV_TYPE];
  if (et < 0) return;  // padding: no-op, preamble included
  const int ev_id = f[EV_ID];
  const int version = f[EV_VERSION];
  const int ts = f[EV_TS];
  const int bf = f[EV_BATCH_FIRST];
  const int slot = f[EV_SLOT];
  const int a0 = f[EV_A0], a1 = f[EV_A1], a2 = f[EV_A2], a3 = f[EV_A3];
  const int a4 = f[EV_A4], a5 = f[EV_A5], a6 = f[EV_A6], a7 = f[EV_A7];
  const int X = p.exec0;

  // ---- preamble (stateBuilder.go:134-155)
  SR(X + X_LAST_EVENT_TASK_ID) = f[EV_TASK_ID];
  SR(X + X_CUR_VERSION) = version;
  SR(X + X_NEXT_EVENT_ID) = wadd(ev_id, 1);
  SR(X + X_LAST_FIRST_EVENT_ID) = bf;

  // ---- version-history AddOrUpdateItem: the read clamps to the last
  // materialized slot; the write keeps the raw last index, so a
  // same-version write past capacity matches no slot
  {
    const int cap_v = p.cap_v;
    const int vh_len = SR(p.vhlen);
    const int last_idx = max(wadd(vh_len, -1), 0);
    const int read_idx = min(last_idx, cap_v - 1);
    int last_ver = 0;
    if (read_idx >= 0 && read_idx < cap_v)
      last_ver = SR(p.vh0 + 2 * read_idx + 1);
    const bool same = vh_len > 0 && last_ver == version;
    const int write_idx = same ? last_idx : min(vh_len, cap_v - 1);
    if (write_idx >= 0 && write_idx < cap_v) {
      SR(p.vh0 + 2 * write_idx) = ev_id;
      SR(p.vh0 + 2 * write_idx + 1) = version;
    }
    if (!same) SR(p.vhlen) = wadd(vh_len, 1);
  }

  int close_status = 0;
  switch (et) {
    // ---- workflow lifecycle
    case WorkflowExecutionStarted:
      SR(X + X_STATE) = WF_CREATED;
      SR(X + X_CLOSE_STATUS) = 0;
      SR(X + X_LAST_PROCESSED_EVENT) = EMPTY_EVENT_ID;
      SR(X + X_START_TS) = ts;
      SR(X + X_WORKFLOW_TIMEOUT) = a0;
      SR(X + X_DECISION_TIMEOUT_VALUE) = a1;
      SR(X + X_ATTEMPT) = a2;
      SR(X + X_HAS_RETRY_POLICY) = a3;
      SR(X + X_WF_EXPIRATION_TS) = a4;
      SR(X + X_PARENT_INITIATED_ID) = a7;
      SR(X + X_DEC_SCHEDULE_ID) = EMPTY_EVENT_ID;
      SR(X + X_DEC_STARTED_ID) = EMPTY_EVENT_ID;
      SR(X + X_DEC_VERSION) = EMPTY_VERSION;
      SR(X + X_DEC_TIMEOUT) = 0;
      SR(X + X_DEC_ATTEMPT) = 0;
      SR(X + X_DEC_SCHEDULED_TS) = 0;
      SR(X + X_DEC_STARTED_TS) = 0;
      SR(X + X_DEC_ORIGINAL_SCHEDULED_TS) = 0;
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
      SR(X + X_CANCEL_REQUESTED) = 1;
      break;
    case WorkflowExecutionSignaled:
      SR(X + X_SIGNAL_COUNT) = wadd(SR(X + X_SIGNAL_COUNT), 1);
      break;

    // ---- decision sub-FSM
    case DecisionTaskScheduled:
      SR(X + X_DEC_VERSION) = version;
      SR(X + X_DEC_SCHEDULE_ID) = ev_id;
      SR(X + X_DEC_STARTED_ID) = EMPTY_EVENT_ID;
      SR(X + X_DEC_TIMEOUT) = a0;
      SR(X + X_DEC_ATTEMPT) = a1;
      SR(X + X_DEC_SCHEDULED_TS) = ts;
      SR(X + X_DEC_ORIGINAL_SCHEDULED_TS) = ts;
      SR(X + X_DEC_STARTED_TS) = 0;
      break;
    case DecisionTaskStarted:
      if (SR(X + X_STATE) == WF_CREATED) SR(X + X_STATE) = WF_RUNNING;
      SR(X + X_DEC_VERSION) = version;
      SR(X + X_DEC_STARTED_ID) = ev_id;
      SR(X + X_DEC_ATTEMPT) = 0;
      SR(X + X_DEC_STARTED_TS) = ts;
      break;
    case DecisionTaskCompleted:
      SR(X + X_DEC_VERSION) = EMPTY_VERSION;
      SR(X + X_DEC_SCHEDULE_ID) = EMPTY_EVENT_ID;
      SR(X + X_DEC_STARTED_ID) = EMPTY_EVENT_ID;
      SR(X + X_DEC_TIMEOUT) = 0;
      SR(X + X_DEC_ATTEMPT) = 0;
      SR(X + X_DEC_SCHEDULED_TS) = 0;
      SR(X + X_DEC_STARTED_TS) = 0;
      SR(X + X_LAST_PROCESSED_EVENT) = a0;
      break;
    case DecisionTaskTimedOut:
    case DecisionTaskFailed: {
      const bool inc = et == DecisionTaskFailed ||
                       a0 != TIMEOUT_SCHEDULE_TO_START;
      if (inc) {
        const int new_attempt = wadd(SR(X + X_DEC_ATTEMPT), 1);
        SR(X + X_DEC_VERSION) = SR(X + X_CUR_VERSION);
        SR(X + X_DEC_SCHEDULE_ID) = bf;
        SR(X + X_DEC_STARTED_ID) = EMPTY_EVENT_ID;
        SR(X + X_DEC_TIMEOUT) = SR(X + X_DECISION_TIMEOUT_VALUE);
        SR(X + X_DEC_ATTEMPT) = new_attempt;
        SR(X + X_DEC_SCHEDULED_TS) = ts;
        SR(X + X_DEC_STARTED_TS) = 0;
        SR(X + X_DEC_ORIGINAL_SCHEDULED_TS) = 0;
      } else {
        SR(X + X_DEC_VERSION) = EMPTY_VERSION;
        SR(X + X_DEC_SCHEDULE_ID) = EMPTY_EVENT_ID;
        SR(X + X_DEC_STARTED_ID) = EMPTY_EVENT_ID;
        SR(X + X_DEC_TIMEOUT) = 0;
        SR(X + X_DEC_ATTEMPT) = 0;
        SR(X + X_DEC_SCHEDULED_TS) = 0;
        SR(X + X_DEC_STARTED_TS) = 0;
        SR(X + X_DEC_ORIGINAL_SCHEDULED_TS) = 0;
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
    SR(X + X_STATE) = WF_COMPLETED;
    SR(X + X_CLOSE_STATUS) = close_status;
    SR(X + X_COMPLETION_EVENT_BATCH_ID) = bf;
  }
}

template <typename EvT>
__global__ void __launch_bounds__(128)
replay_fsm_kernel(const EvT* __restrict__ ev, const int* rows_in,
                  int* rows_out, const Params p) {
  extern __shared__ int smem[];
  const int lanes = blockDim.x;
  const int b = blockIdx.x * lanes + threadIdx.x;
  if (b >= p.B) return;
  int* st = smem + threadIdx.x;
  const size_t B = (size_t)p.B;
  for (int r = 0; r < p.R; ++r) SR(r) = rows_in[(size_t)r * B + b];

  if (p.t0 < p.t1) {
    // the loads of the next two steps are in flight while a step
    // applies; indices past the window clamp to its last step (a reload
    // that is never applied)
    const int last = p.t1 - 1;
    Raw cur, n1;
    load_raw(ev, p, p.t0, b, cur);
    load_raw(ev, p, min(p.t0 + 1, last), b, n1);
    for (int t = p.t0; t < p.t1; ++t) {
      Raw n2;
      load_raw(ev, p, min(t + 2, last), b, n2);
      int f[EV_N];
      decode<EvT>(cur, p, f);
      apply_step(st, lanes, p, f);
      cur = n1;
      n1 = n2;
    }
  }
  for (int r = 0; r < p.R; ++r) rows_out[(size_t)r * B + b] = SR(r);
}

#undef SR

template <typename EvT>
cudaError_t launch(const void* events, const int* rows_in, int* rows_out,
                   const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.R * p.lanes * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      replay_fsm_kernel<EvT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.B + p.lanes - 1) / p.lanes);
  replay_fsm_kernel<EvT><<<grid, p.lanes, smem, stream>>>(
      static_cast<const EvT*>(events), rows_in, rows_out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Replays steps [t0, t1) of events [T, P, B] (int32, or int16 when
// ev_int16) onto rows_in [R, B] int32, writing rows_out [R, B] (may alias
// rows_in). hp: the N_PARAMS ints of Params. Returns a cudaError_t.
int cadence_replay_fsm(const void* events, int ev_int16, const int* rows_in,
                       int* rows_out, const int* hp, int n_params,
                       void* stream, int device) {
  if (n_params != N_PARAMS) return (int)cudaErrorInvalidValue;
  Params p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PARAMS; ++i) dst[i] = hp[i];
  if (p.B <= 0 || p.lanes <= 0 || p.lanes > 128 ||
      p.P != EV_N + (ev_int16 ? __builtin_popcount(p.wide_mask) : 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = ev_int16 ? launch<int16_t>(events, rows_in, rows_out, p, s)
               : launch<int32_t>(events, rows_in, rows_out, p, s);
  return (int)e;
}

const char* cadence_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
