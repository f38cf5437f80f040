// The port's native sidecar: the host-side steps of packing and the
// compiled host baseline, with a C ABI for ctypes.
//
// - Fused scatters of ragged per-workflow event rows into the dense
//   layouts the replay consumes: time-major [T, B, E], batch-major
//   [B, T, E] (PackedHistories.events) and field-major [T, E, B] (the
//   CUDA FSM kernel's operand, ops/replay_cuda.py), in one pass each
//   instead of a per-workflow numpy loop.
// - ct_replay_sequential: the compiled sequential replayer that a replay
//   measures its rate against.
// - ct_fnv1a32_batch: bulk FNV-1a id hashing.
// - The replication transport's tensor codec (ct_tensor_compress /
//   _decompress / _peek_count, ct_compress_bound): zigzag + varint over
//   int32 deltas, the wire form of a snapshot-shipped state row.
//
// A trimmed copy of the reference package's native/sidecar.cpp, equal to
// it function for function in what it keeps. All buffers are allocated by
// the caller (numpy arrays, cadence_tpu_torch/native/__init__.py checks
// them before any pointer reaches this file).

#include <cstdint>
#include <cstring>

extern "C" {

// -- scatter: ragged rows -> dense time-major ---------------------------
//
// rows:    [total_events, ev_n] int32, workflows concatenated in order
// lengths: [batch] int64, events per workflow (sum == total_events)
// out:     [max_events, batch, ev_n] int32, fully overwritten:
//          valid slots get their row; padding gets type_pad at column 0
//          (EV_TYPE) and zeros elsewhere.
void ct_scatter_time_major(const int32_t* rows, const int64_t* lengths,
                           int64_t batch, int64_t ev_n, int64_t max_events,
                           int32_t type_pad, int32_t* out) {
    // one sequential pass over the destination (the big buffer):
    // per (t, b) either copy the event row or write the padding row
    const int64_t plane = batch * ev_n;
    // per-workflow source cursors
    const int32_t** srcs = new const int32_t*[batch];
    {
        const int32_t* p = rows;
        for (int64_t b = 0; b < batch; ++b) {
            srcs[b] = p;
            p += lengths[b] * ev_n;
        }
    }
    // rows are short (EV_N ~ a dozen int32) — an open-coded copy beats
    // a memcpy call per row
    for (int64_t t = 0; t < max_events; ++t) {
        int32_t* dst = out + t * plane;
        for (int64_t b = 0; b < batch; ++b, dst += ev_n) {
            if (t < lengths[b]) {
                const int32_t* s = srcs[b] + t * ev_n;
                for (int64_t k = 0; k < ev_n; ++k) dst[k] = s[k];
            } else {
                dst[0] = type_pad;  // EV_TYPE padding sentinel
                for (int64_t k = 1; k < ev_n; ++k) dst[k] = 0;
            }
        }
    }
    delete[] srcs;
}

// batch-major variant: out [batch, max_events, ev_n]
void ct_scatter_batch_major(const int32_t* rows, const int64_t* lengths,
                            int64_t batch, int64_t ev_n, int64_t max_events,
                            int32_t type_pad, int32_t* out) {
    const int64_t plane = max_events * ev_n;
    std::memset(out, 0, sizeof(int32_t) * batch * plane);
    for (int64_t b = 0; b < batch; ++b) {
        int32_t* wf = out + b * plane;
        for (int64_t t = 0; t < max_events; ++t) {
            wf[t * ev_n] = type_pad;
        }
    }
    const int32_t* src = rows;
    for (int64_t b = 0; b < batch; ++b) {
        const int64_t n = lengths[b];
        // clamp to the plane: an oversized workflow copies its first
        // max_events rows (mirrors the time-major loop bound) instead
        // of overrunning the destination
        const int64_t n_copy = n < max_events ? n : max_events;
        if (n_copy > 0) {
            std::memcpy(out + b * plane, src, sizeof(int32_t) * n_copy * ev_n);
        }
        src += n * ev_n;
    }
}

// field-major variant: out [max_events, ev_n, batch] — the layout the
// CUDA FSM kernel consumes directly (per-field planes with batch as the
// contiguous minor dim, so a block's lanes read contiguous runs of each
// step's fields). Producing it here replaces a host transpose of the
// batch-major tensor.
void ct_scatter_teb(const int32_t* rows, const int64_t* lengths,
                    int64_t batch, int64_t ev_n, int64_t max_events,
                    int32_t type_pad, int32_t* out) {
    const int64_t plane = ev_n * batch;
    const int32_t** srcs = new const int32_t*[batch];
    {
        const int32_t* p = rows;
        for (int64_t b = 0; b < batch; ++b) {
            srcs[b] = p;
            p += lengths[b] * ev_n;
        }
    }
    // writes are contiguous per (t, field) run; reads of the source rows
    // are blocked over lanes so each block's rows stay cache-resident
    // across the ev_n field passes
    const int64_t BLK = 512;
    for (int64_t t = 0; t < max_events; ++t) {
        int32_t* tp = out + t * plane;
        for (int64_t b0 = 0; b0 < batch; b0 += BLK) {
            const int64_t b1 = b0 + BLK < batch ? b0 + BLK : batch;
            for (int64_t f = 0; f < ev_n; ++f) {
                int32_t* dst = tp + f * batch;
                const int32_t pad = f == 0 ? type_pad : 0;
                for (int64_t b = b0; b < b1; ++b) {
                    dst[b] = t < lengths[b] ? srcs[b][t * ev_n + f] : pad;
                }
            }
        }
    }
    delete[] srcs;
}

// -- hashing ------------------------------------------------------------
//
// FNV-1a 32-bit over each string, masked to 31 bits (utils/hashing.py's
// hash31 for a batch).
void ct_fnv1a32_batch(const char* data, const int64_t* offsets,
                      int64_t n, uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint32_t h = 2166136261u;
        for (int64_t p = offsets[i]; p < offsets[i + 1]; ++p) {
            h ^= (uint8_t)data[p];
            h *= 16777619u;
        }
        out[i] = h & 0x7fffffffu;
    }
}

// -- transport codec ----------------------------------------------------
//
// zigzag + varint over int32 deltas (consecutive values of a state row
// are strongly correlated). Encoded layout: varint(count) then count
// varints of zigzag(delta). Deltas wrap mod 2^32.

static inline uint32_t zigzag32(int32_t v) {
    return ((uint32_t)v << 1) ^ (uint32_t)(v >> 31);
}

static inline int32_t unzigzag32(uint32_t v) {
    return (int32_t)(v >> 1) ^ -(int32_t)(v & 1);
}

static inline uint8_t* put_varint(uint8_t* p, uint32_t v) {
    while (v >= 0x80) {
        *p++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *p++ = (uint8_t)v;
    return p;
}

// bounded read: returns the advanced cursor, or nullptr on truncation
// or an overlong (>5 byte) varint
static inline const uint8_t* get_varint(const uint8_t* p, const uint8_t* end,
                                        uint32_t* v) {
    uint32_t out = 0;
    int shift = 0;
    while (true) {
        if (p >= end || shift > 28) return nullptr;
        uint8_t b = *p++;
        out |= (uint32_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    *v = out;
    return p;
}

// Worst case: 5 bytes per value + 5-byte header.
int64_t ct_compress_bound(int64_t n) { return 5 * n + 5; }

// returns the encoded byte count
int64_t ct_tensor_compress(const int32_t* data, int64_t n, uint8_t* out) {
    uint8_t* p = put_varint(out, (uint32_t)n);
    uint32_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t cur = (uint32_t)data[i];
        p = put_varint(p, zigzag32((int32_t)(cur - prev)));
        prev = cur;
    }
    return (int64_t)(p - out);
}

// returns the decoded element count (the caller sized `out` from the
// header), or -1 on a truncated or malformed blob
int64_t ct_tensor_decompress(const uint8_t* blob, int64_t blob_len,
                             int32_t* out) {
    const uint8_t* end = blob + blob_len;
    uint32_t n;
    const uint8_t* p = get_varint(blob, end, &n);
    if (p == nullptr) return -1;
    uint32_t prev = 0;
    for (uint32_t i = 0; i < n; ++i) {
        uint32_t z;
        p = get_varint(p, end, &z);
        if (p == nullptr) return -1;
        prev += (uint32_t)unzigzag32(z);
        out[i] = (int32_t)prev;
    }
    return (int64_t)n;
}

// the element count without decoding; -1 on a malformed header
int64_t ct_tensor_peek_count(const uint8_t* blob, int64_t blob_len) {
    uint32_t n;
    if (get_varint(blob, blob + blob_len, &n) == nullptr) return -1;
    return (int64_t)n;
}

// -- sequential replayer ------------------------------------------------
//
// The compiled-host baseline: replays packed histories one workflow at
// a time, one event at a time, with the exact transition semantics of
// the FSM kernel (ops/csrc/replay_fsm.cu and its plain version in
// ops/replay_cuda.py == the host oracle core/state_builder.py == the
// reference's stateBuilder.applyEvents loop,
// service/history/stateBuilder.go:112-613). This is what an optimized
// single-thread CPU implementation of the replay loop looks like: a
// replay's rate is measured against it, not against interpreted Python.
//
// Column layout constants mirror cadence_tpu_torch/ops/schema.py; the
// differential tests (tests/test_torch_native.py) assert bit-for-bit
// parity with the plain FSM, which pins both the constants and the
// semantics.

namespace {

// EventType (core/enums.py)
enum {
    EV_WF_STARTED = 0, EV_WF_COMPLETED = 1, EV_WF_FAILED = 2,
    EV_WF_TIMEDOUT = 3, EV_DEC_SCHEDULED = 4, EV_DEC_STARTED = 5,
    EV_DEC_COMPLETED = 6, EV_DEC_TIMEDOUT = 7, EV_DEC_FAILED = 8,
    EV_ACT_SCHEDULED = 9, EV_ACT_STARTED = 10, EV_ACT_COMPLETED = 11,
    EV_ACT_FAILED = 12, EV_ACT_TIMEDOUT = 13, EV_ACT_CANCEL_REQ = 14,
    EV_ACT_CANCELED = 16, EV_TIMER_STARTED = 17, EV_TIMER_FIRED = 18,
    EV_TIMER_CANCELED = 20, EV_WF_CANCEL_REQ = 21, EV_WF_CANCELED = 22,
    EV_RC_INITIATED = 23, EV_RC_FAILED = 24, EV_RC_EXT_REQUESTED = 25,
    EV_WF_SIGNALED = 27, EV_WF_TERMINATED = 28, EV_WF_CONTINUED = 29,
    EV_CHILD_INITIATED = 30, EV_CHILD_INIT_FAILED = 31,
    EV_CHILD_STARTED = 32, EV_CHILD_COMPLETED = 33, EV_CHILD_FAILED = 34,
    EV_CHILD_CANCELED = 35, EV_CHILD_TIMEDOUT = 36,
    EV_CHILD_TERMINATED = 37, EV_SG_INITIATED = 38, EV_SG_FAILED = 39,
    EV_SG_EXT_SIGNALED = 40,
};

// event row columns (schema.py EV_*)
enum { C_TYPE = 0, C_ID = 1, C_VERSION = 2, C_TASK_ID = 3, C_TS = 4,
       C_BATCH_FIRST = 5, C_IS_BATCH_LAST = 6, C_SLOT = 7, C_A0 = 8 };
constexpr int EV_N = 16;

// exec-info columns (schema.py X_*)
enum { X_STATE = 0, X_CLOSE_STATUS = 1, X_NEXT_EVENT_ID = 2,
       X_LAST_FIRST_EVENT_ID = 3, X_LAST_EVENT_TASK_ID = 4,
       X_LAST_PROCESSED_EVENT = 5, X_START_TS = 6, X_WORKFLOW_TIMEOUT = 7,
       X_DECISION_TIMEOUT_VALUE = 8, X_DEC_VERSION = 9,
       X_DEC_SCHEDULE_ID = 10, X_DEC_STARTED_ID = 11, X_DEC_TIMEOUT = 12,
       X_DEC_ATTEMPT = 13, X_DEC_SCHEDULED_TS = 14, X_DEC_STARTED_TS = 15,
       X_DEC_ORIGINAL_SCHEDULED_TS = 16, X_CANCEL_REQUESTED = 17,
       X_SIGNAL_COUNT = 18, X_ATTEMPT = 19, X_HAS_RETRY_POLICY = 20,
       X_COMPLETION_EVENT_BATCH_ID = 21, X_PARENT_INITIATED_ID = 22,
       X_WF_EXPIRATION_TS = 23, X_CUR_VERSION = 24 };
constexpr int X_N = 25;

// activity slot columns (schema.py AC_*)
enum { AC_OCC = 0, AC_VERSION = 1, AC_SCHEDULE_ID = 2,
       AC_SCHEDULED_BATCH_ID = 3, AC_SCHEDULED_TS = 4, AC_STARTED_ID = 5,
       AC_STARTED_TS = 6, AC_ID_HASH = 7, AC_SCH_TO_START = 8,
       AC_SCH_TO_CLOSE = 9, AC_START_TO_CLOSE = 10, AC_HEARTBEAT = 11,
       AC_CANCEL_REQUESTED = 12, AC_CANCEL_REQUEST_ID = 13,
       AC_ATTEMPT = 14, AC_HAS_RETRY = 15, AC_EXPIRATION_TS = 16,
       AC_LAST_HB_TS = 17, AC_TIMER_STATUS = 18 };
constexpr int AC_N = 19;

enum { TI_OCC = 0, TI_VERSION = 1, TI_STARTED_ID = 2, TI_ID_HASH = 3,
       TI_EXPIRY_TS = 4, TI_STATUS = 5 };
constexpr int TI_N = 6;

enum { CH_OCC = 0, CH_VERSION = 1, CH_INITIATED_ID = 2,
       CH_INITIATED_BATCH_ID = 3, CH_STARTED_ID = 4, CH_WF_ID_HASH = 5,
       CH_RUN_ID_HASH = 6, CH_POLICY = 7 };
constexpr int CH_N = 8;

constexpr int RC_N = 4;  // OCC, VERSION, INITIATED_ID, INITIATED_BATCH_ID
constexpr int SG_N = 4;

constexpr int32_t EMPTY_EVENT_ID = -23;
constexpr int32_t EMPTY_VERSION = -24;
constexpr int32_t WF_STATE_CREATED = 0, WF_STATE_RUNNING = 1,
                  WF_STATE_COMPLETED = 2;
constexpr int32_t TIMEOUT_SCHEDULE_TO_START = 1;

inline void clear_row(int32_t* row, int n) {
    for (int k = 0; k < n; ++k) row[k] = 0;
}

}  // namespace

void ct_replay_sequential(
    const int32_t* events, const int64_t* lengths, int64_t batch, int64_t T,
    int64_t cap_a, int64_t cap_t, int64_t cap_c, int64_t cap_rc,
    int64_t cap_sg, int64_t cap_v,
    int32_t* exec_info, int32_t* activities, int32_t* timers,
    int32_t* children, int32_t* cancels, int32_t* signals,
    int32_t* vh_items, int32_t* vh_len) {
    for (int64_t b = 0; b < batch; ++b) {
        int32_t* ex = exec_info + b * X_N;
        int32_t* act = activities + b * cap_a * AC_N;
        int32_t* tim = timers + b * cap_t * TI_N;
        int32_t* chd = children + b * cap_c * CH_N;
        int32_t* rc = cancels + b * cap_rc * RC_N;
        int32_t* sg = signals + b * cap_sg * SG_N;
        int32_t* vh = vh_items + b * cap_v * 2;
        const int64_t n = lengths[b] < T ? lengths[b] : T;
        for (int64_t t = 0; t < n; ++t) {
            const int32_t* ev = events + (b * T + t) * EV_N;
            const int32_t et = ev[C_TYPE];
            if (et < 0) continue;
            const int32_t ev_id = ev[C_ID], version = ev[C_VERSION];
            const int32_t ts = ev[C_TS], batch_first = ev[C_BATCH_FIRST];
            const int32_t slot = ev[C_SLOT];
            const int32_t a0 = ev[C_A0], a1 = ev[C_A0 + 1],
                          a2 = ev[C_A0 + 2], a3 = ev[C_A0 + 3],
                          a4 = ev[C_A0 + 4], a5 = ev[C_A0 + 5],
                          a6 = ev[C_A0 + 6], a7 = ev[C_A0 + 7];

            // preamble (stateBuilder.go:134-155)
            ex[X_LAST_EVENT_TASK_ID] = ev[C_TASK_ID];
            ex[X_CUR_VERSION] = version;
            ex[X_NEXT_EVENT_ID] = ev_id + 1;
            ex[X_LAST_FIRST_EVENT_ID] = batch_first;

            // version-history AddOrUpdateItem. Mirrors the FSM kernel
            // exactly when vh_len outgrows cap_v: the READ clamps to
            // cap-1 and a same-branch write at an index >= cap is
            // dropped; an unclamped index would reach past this
            // workflow's window (cross-row corruption, a heap write at
            // b = B-1)
            {
                const int32_t len = vh_len[b];
                const int32_t cap = (int32_t)cap_v;
                const int32_t last_idx = len > 0 ? len - 1 : 0;
                const int32_t read_idx =
                    last_idx < cap ? last_idx : cap - 1;
                const bool same =
                    len > 0 && vh[read_idx * 2 + 1] == version;
                const int32_t wi =
                    same ? last_idx : (len < cap - 1 ? len : cap - 1);
                if (wi < cap) {
                    vh[wi * 2] = ev_id;
                    vh[wi * 2 + 1] = version;
                }
                if (!same) vh_len[b] = len + 1;
            }

            switch (et) {
            case EV_WF_STARTED:
                ex[X_STATE] = WF_STATE_CREATED;
                ex[X_CLOSE_STATUS] = 0;
                ex[X_LAST_PROCESSED_EVENT] = EMPTY_EVENT_ID;
                ex[X_START_TS] = ts;
                ex[X_WORKFLOW_TIMEOUT] = a0;
                ex[X_DECISION_TIMEOUT_VALUE] = a1;
                ex[X_ATTEMPT] = a2;
                ex[X_HAS_RETRY_POLICY] = a3;
                ex[X_WF_EXPIRATION_TS] = a4;
                ex[X_PARENT_INITIATED_ID] = a7;
                ex[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
                ex[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
                ex[X_DEC_VERSION] = EMPTY_VERSION;
                ex[X_DEC_TIMEOUT] = 0;
                ex[X_DEC_ATTEMPT] = 0;
                ex[X_DEC_SCHEDULED_TS] = 0;
                ex[X_DEC_STARTED_TS] = 0;
                ex[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
                break;
            case EV_WF_COMPLETED: case EV_WF_FAILED: case EV_WF_TIMEDOUT:
            case EV_WF_CANCELED: case EV_WF_TERMINATED: case EV_WF_CONTINUED: {
                // CloseStatus: Completed=1 Failed=2 Canceled=3 Terminated=4
                // ContinuedAsNew=5 TimedOut=6
                int32_t cs = 0;
                switch (et) {
                case EV_WF_COMPLETED: cs = 1; break;
                case EV_WF_FAILED: cs = 2; break;
                case EV_WF_TIMEDOUT: cs = 6; break;
                case EV_WF_CANCELED: cs = 3; break;
                case EV_WF_TERMINATED: cs = 4; break;
                case EV_WF_CONTINUED: cs = 5; break;
                }
                ex[X_STATE] = WF_STATE_COMPLETED;
                ex[X_CLOSE_STATUS] = cs;
                ex[X_COMPLETION_EVENT_BATCH_ID] = batch_first;
                break;
            }
            case EV_WF_CANCEL_REQ:
                ex[X_CANCEL_REQUESTED] = 1;
                break;
            case EV_WF_SIGNALED:
                ex[X_SIGNAL_COUNT] += 1;
                break;
            case EV_DEC_SCHEDULED:
                ex[X_DEC_VERSION] = version;
                ex[X_DEC_SCHEDULE_ID] = ev_id;
                ex[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
                ex[X_DEC_TIMEOUT] = a0;
                ex[X_DEC_ATTEMPT] = a1;
                ex[X_DEC_SCHEDULED_TS] = ts;
                ex[X_DEC_ORIGINAL_SCHEDULED_TS] = ts;
                ex[X_DEC_STARTED_TS] = 0;
                break;
            case EV_DEC_STARTED:
                if (ex[X_STATE] == WF_STATE_CREATED)
                    ex[X_STATE] = WF_STATE_RUNNING;
                ex[X_DEC_VERSION] = version;
                ex[X_DEC_STARTED_ID] = ev_id;
                ex[X_DEC_ATTEMPT] = 0;  // replication magic (:216-224)
                ex[X_DEC_STARTED_TS] = ts;
                break;
            case EV_DEC_COMPLETED:
                ex[X_DEC_VERSION] = EMPTY_VERSION;
                ex[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
                ex[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
                ex[X_DEC_TIMEOUT] = 0;
                ex[X_DEC_ATTEMPT] = 0;
                ex[X_DEC_SCHEDULED_TS] = 0;
                ex[X_DEC_STARTED_TS] = 0;
                ex[X_LAST_PROCESSED_EVENT] = a0;
                break;
            case EV_DEC_TIMEDOUT: case EV_DEC_FAILED: {
                const bool increment =
                    et == EV_DEC_FAILED || a0 != TIMEOUT_SCHEDULE_TO_START;
                if (increment) {
                    const int32_t new_attempt = ex[X_DEC_ATTEMPT] + 1;
                    ex[X_DEC_VERSION] = ex[X_CUR_VERSION];
                    ex[X_DEC_SCHEDULE_ID] = batch_first;
                    ex[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
                    ex[X_DEC_TIMEOUT] = ex[X_DECISION_TIMEOUT_VALUE];
                    ex[X_DEC_ATTEMPT] = new_attempt;
                    ex[X_DEC_SCHEDULED_TS] = ts;
                    ex[X_DEC_STARTED_TS] = 0;
                    ex[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
                } else {
                    ex[X_DEC_VERSION] = EMPTY_VERSION;
                    ex[X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID;
                    ex[X_DEC_STARTED_ID] = EMPTY_EVENT_ID;
                    ex[X_DEC_TIMEOUT] = 0;
                    ex[X_DEC_ATTEMPT] = 0;
                    ex[X_DEC_SCHEDULED_TS] = 0;
                    ex[X_DEC_STARTED_TS] = 0;
                    ex[X_DEC_ORIGINAL_SCHEDULED_TS] = 0;
                }
                break;
            }
            case EV_ACT_SCHEDULED: {
                if (slot < 0 || slot >= cap_a) break;
                int32_t* row = act + slot * AC_N;
                const int32_t exp_interval =
                    (a5 > 0 && a6 > a2) ? a6 : a2;
                row[AC_OCC] = 1;
                row[AC_VERSION] = version;
                row[AC_SCHEDULE_ID] = ev_id;
                row[AC_SCHEDULED_BATCH_ID] = batch_first;
                row[AC_SCHEDULED_TS] = ts;
                row[AC_STARTED_ID] = EMPTY_EVENT_ID;
                row[AC_STARTED_TS] = 0;
                row[AC_ID_HASH] = a0;
                row[AC_SCH_TO_START] = a1;
                row[AC_SCH_TO_CLOSE] = a2;
                row[AC_START_TO_CLOSE] = a3;
                row[AC_HEARTBEAT] = a4;
                row[AC_CANCEL_REQUESTED] = 0;
                row[AC_CANCEL_REQUEST_ID] = EMPTY_EVENT_ID;
                row[AC_ATTEMPT] = 0;
                row[AC_HAS_RETRY] = a5;
                row[AC_EXPIRATION_TS] = ts + exp_interval;
                row[AC_LAST_HB_TS] = 0;
                row[AC_TIMER_STATUS] = 0;
                break;
            }
            case EV_ACT_STARTED: {
                if (slot < 0 || slot >= cap_a) break;
                int32_t* row = act + slot * AC_N;
                row[AC_VERSION] = version;
                row[AC_STARTED_ID] = ev_id;
                row[AC_STARTED_TS] = ts;
                row[AC_LAST_HB_TS] = ts;
                row[AC_ATTEMPT] = a1;
                break;
            }
            case EV_ACT_COMPLETED: case EV_ACT_FAILED:
            case EV_ACT_TIMEDOUT: case EV_ACT_CANCELED:
                if (slot >= 0 && slot < cap_a)
                    clear_row(act + slot * AC_N, AC_N);
                break;
            case EV_ACT_CANCEL_REQ: {
                if (slot < 0 || slot >= cap_a) break;
                int32_t* row = act + slot * AC_N;
                row[AC_VERSION] = version;
                row[AC_CANCEL_REQUESTED] = 1;
                row[AC_CANCEL_REQUEST_ID] = ev_id;
                break;
            }
            case EV_TIMER_STARTED: {
                if (slot < 0 || slot >= cap_t) break;
                int32_t* row = tim + slot * TI_N;
                row[TI_OCC] = 1;
                row[TI_VERSION] = version;
                row[TI_STARTED_ID] = ev_id;
                row[TI_ID_HASH] = a0;
                row[TI_EXPIRY_TS] = ts + a1;
                row[TI_STATUS] = 0;
                break;
            }
            case EV_TIMER_FIRED: case EV_TIMER_CANCELED:
                if (slot >= 0 && slot < cap_t)
                    clear_row(tim + slot * TI_N, TI_N);
                break;
            case EV_CHILD_INITIATED: {
                if (slot < 0 || slot >= cap_c) break;
                int32_t* row = chd + slot * CH_N;
                row[CH_OCC] = 1;
                row[CH_VERSION] = version;
                row[CH_INITIATED_ID] = ev_id;
                row[CH_INITIATED_BATCH_ID] = batch_first;
                row[CH_STARTED_ID] = EMPTY_EVENT_ID;
                row[CH_WF_ID_HASH] = a0;
                row[CH_RUN_ID_HASH] = 0;
                row[CH_POLICY] = a1;
                break;
            }
            case EV_CHILD_STARTED: {
                if (slot < 0 || slot >= cap_c) break;
                int32_t* row = chd + slot * CH_N;
                row[CH_STARTED_ID] = ev_id;
                row[CH_RUN_ID_HASH] = a1;
                break;
            }
            case EV_CHILD_INIT_FAILED: case EV_CHILD_COMPLETED:
            case EV_CHILD_FAILED: case EV_CHILD_CANCELED:
            case EV_CHILD_TIMEDOUT: case EV_CHILD_TERMINATED:
                if (slot >= 0 && slot < cap_c)
                    clear_row(chd + slot * CH_N, CH_N);
                break;
            case EV_RC_INITIATED: {
                if (slot < 0 || slot >= cap_rc) break;
                int32_t* row = rc + slot * RC_N;
                row[0] = 1; row[1] = version; row[2] = ev_id;
                row[3] = batch_first;
                break;
            }
            case EV_RC_FAILED: case EV_RC_EXT_REQUESTED:
                if (slot >= 0 && slot < cap_rc)
                    clear_row(rc + slot * RC_N, RC_N);
                break;
            case EV_SG_INITIATED: {
                if (slot < 0 || slot >= cap_sg) break;
                int32_t* row = sg + slot * SG_N;
                row[0] = 1; row[1] = version; row[2] = ev_id;
                row[3] = batch_first;
                break;
            }
            case EV_SG_FAILED: case EV_SG_EXT_SIGNALED:
                if (slot >= 0 && slot < cap_sg)
                    clear_row(sg + slot * SG_N, SG_N);
                break;
            default:
                break;  // MarkerRecorded, UpsertSearchAttributes, etc.
            }
        }
    }
}

}  // extern "C"
