"""The port's device task refresh (``cadence_tpu_torch.ops.refresh``)
against the reference package's, on the CPU.

The same state arrays go through the reference's jitted
``refresh_tasks_device`` and the port's torch version; all twelve fields
must agree exactly, dtypes included. States come from fuzzed replays
and from crafted tables that hit the tie and overflow rules (equal
expiries across slots and candidate kinds, duplicate schedule ids,
timeouts of 0, ``ts + timeout`` wrapping int32, an expiry of exactly
2**31 - 1, ids of 2**31 - 1, negative attempts). ``hydrate_tasks`` is
held against the reference's and against the port's host
``refresh_tasks``; the replay + refresh step against the reference's
``replay_scan`` + ``refresh_tasks_device``.

The CUDA kernel behind ``refresh_tasks_device`` runs on the card only
(``chip_smoke.py`` holds it against ``refresh_tasks_plain`` there on the
same crafted states); here its launch plan, its operand checks, its C
signature, its source's constants and the CPU route are checked."""

import ctypes
import dataclasses
import itertools
import random
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import refresh as JR
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.replay import replay_packed as j_replay_packed
from cadence_tpu.ops.replay import replay_scan as j_replay_scan

from cadence_tpu_torch.core import version_history as VH
from cadence_tpu_torch.core.enums import TimerTaskType
from cadence_tpu_torch.core.events import HistoryEvent
from cadence_tpu_torch.core.ids import EMPTY_EVENT_ID
from cadence_tpu_torch.core.mutable_state import MutableState
from cadence_tpu_torch.core.state_builder import StateBuilder
from cadence_tpu_torch.core.task_refresher import refresh_tasks
from cadence_tpu_torch.ops import _build
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import refresh as R
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.refresh import (
    FIELDS, RefreshedTasks, hydrate_tasks, refresh_tasks_device,
    refreshed_to_numpy,
)
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.testing import workloads as W
from cadence_tpu_torch.testing.event_generator import HistoryFuzzer
from cadence_tpu_torch.testing import refresh_states as RS
from cadence_tpu_torch.testing.refresh_states import (
    SMALL_CAPS, crafted_state, edge_state, full_tie_state, int32_max_state,
)

from test_replay_differential import ALL_SCENARIOS

RETRY_CAPS = S.Capacities(
    max_events=1024, max_activities=4, max_timers=2, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=2)
BOOL_FIELDS = ("close_transfer", "first_decision_pending")
BIG = 2**31 - 1


def j_refresh(state) -> JR.RefreshedTasks:
    """The reference's refresh of numpy state, as numpy."""
    fields = {f: np.asarray(getattr(state, f)) for f in S.STATE_ROW_FIELDS}
    return JR.refreshed_to_numpy(
        JR.refresh_tasks_device_jit(JS.StateTensors(**fields)))


def assert_refreshed_equal(got: RefreshedTasks, want) -> None:
    """Every field equal, with the pinned dtypes: bool for the two flags,
    int32 for the rest."""
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(g, torch.Tensor), f
        pinned = torch.bool if f in BOOL_FIELDS else torch.int32
        assert g.dtype == pinned, (f, g.dtype)
        assert w.dtype == (np.bool_ if f in BOOL_FIELDS else np.int32), f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def fuzzed_final(seed, caps, n=6, target=120):
    fz = HistoryFuzzer(seed=seed, caps=caps)
    hs = [(f"wf-{i}", f"run-{i}",
           fz.generate(target_events=target + 20 * i, close=i % 3 == 0))
          for i in range(n)]
    pk = P.pack_histories(hs, caps=caps)
    return pk, replay_packed(pk, device="cpu")


@pytest.mark.parametrize("seed,caps", [
    (1, None), (2, None), (3, SMALL_CAPS), (4, RETRY_CAPS), (5, RETRY_CAPS),
], ids=["default-1", "default-2", "small-3", "retry-4", "retry-5"])
def test_refresh_matches_reference_on_fuzzed_finals(seed, caps):
    pk, final = fuzzed_final(seed, caps or S.Capacities())
    got = refresh_tasks_device(S.state_from_numpy(final, "cpu"))
    assert_refreshed_equal(got, j_refresh(final))
    # the fuzzed finals arm tasks: the comparison is not all -1s
    assert (got.activity_timer[:, 0] >= 0).any() or \
        (got.decision_transfer >= 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refresh_matches_reference_on_crafted_ties_and_overflow(seed):
    caps = SMALL_CAPS if seed % 2 else RETRY_CAPS
    st = crafted_state(seed, 512, caps)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    # the draw reaches the rules it is for
    timer = got.activity_timer.numpy()
    assert (timer[:, 0] >= 0).any() and (timer[:, 0] == -1).any()
    assert (timer[:, 0] < 0).sum() > (timer[:, 1] < 0).sum(), \
        "a wrapped (negative) expiry wins somewhere"
    assert len(np.unique(timer[timer[:, 0] >= 0, 1])) == 4, \
        "every timeout type wins somewhere"


def test_full_tie_takes_the_earlier_kind_and_its_winners():
    """Two slots with one schedule id and one expiry, one unstarted and
    one started, both armed by schedule-to-close: the unstarted kind
    comes first in the reference's order, so its slot's attempt and
    version win, not the max over both slots."""
    st = full_tie_state(SMALL_CAPS)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [15, 2, 4, 1, 2]


def test_expiry_of_int32_max_reads_as_absent():
    """An armed candidate whose expiry is exactly 2**31 - 1 is no task,
    in both packages; one past it wraps negative and wins."""
    st = int32_max_state(SMALL_CAPS, 5)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [-1] * 5
    st = int32_max_state(SMALL_CAPS, 6)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [-(2**31), 1, 4, 0, 0]


EDGE_CAPS = {"retry": RETRY_CAPS, **RS.EDGE_CAPS}


@pytest.mark.parametrize("name", sorted(EDGE_CAPS))
def test_refresh_matches_reference_on_edge_states(name):
    """The rules' edges, which the kernel reduces across a group of
    threads: a least id of 2**31 - 1 makes every slot a tied winner, and
    where every slot wins, attempt takes no 0 from a losing slot."""
    caps = EDGE_CAPS[name]
    st = edge_state(7, 512, caps)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    # the draw reaches the edges it is for
    timer = got.activity_timer
    assert (timer[:, 2] == BIG).any()
    assert (got.user_timer[:, 1] == BIG).any()
    assert ((timer[:, 1] >= 0) & (timer[:, 3] < 0)).any(), \
        "a negative attempt wins somewhere"


NDC_CAPS = S.Capacities(
    max_events=1024, max_activities=32, max_timers=16, max_children=16,
    max_request_cancels=8, max_signals_ext=8, max_version_items=8)


@pytest.mark.parametrize("caps,group,lanes", [
    (RETRY_CAPS, 1, 64), (NDC_CAPS, 8, 8), (S.Capacities(), 8, 8),
    (EDGE_CAPS["odd"], 2, 32), (EDGE_CAPS["one-slot"], 1, 128),
    (RS.HUGE_CAPS, 32, 1),
], ids=["retry_deep", "ndc_storm", "default", "odd", "one-slot", "huge"])
def test_refresh_plan_fits_shared_memory_and_covers_every_lane(
        caps, group, lanes):
    """A group of threads a lane, each taking at most 4 slots of the
    widest table, up to a warp; the widest tile of whole warps, at most
    256 threads, whose six slabs fit 48 KB (or one warp's worth, within
    a block's 227 KB); each slab holds every lane of the tile, at a
    16-byte boundary, apart from the others."""
    plan = R.refresh_plan(caps)
    assert (plan["group"], plan["lanes_per_block"]) == (group, lanes)
    widest = max(caps.max_activities, caps.max_timers, caps.max_children,
                 caps.max_request_cancels, caps.max_signals_ext)
    assert group * 4 >= min(128, widest) and group & (group - 1) == 0
    assert plan["threads"] == group * lanes <= 256
    assert plan["threads"] % 32 == 0
    assert plan["smem_bytes"] <= 48 * 1024 or lanes * group == 32
    lane_bytes = 4 * (S.X_N + caps.max_activities * S.AC_N
                      + caps.max_timers * S.TI_N
                      + caps.max_children * S.CH_N
                      + caps.max_request_cancels * S.RC_N
                      + caps.max_signals_ext * S.SG_N)
    # the slabs, each at a 16-byte boundary
    assert lane_bytes * lanes <= plan["smem_bytes"] < (
        lane_bytes * lanes + 6 * 16)
    assert plan["smem_bytes"] <= _build.H100.block_smem
    # the huge caps take the path past 48 KB, which chip_smoke.py keeps
    assert (plan["smem_bytes"] > 48 * 1024) == (caps is RS.HUGE_CAPS)
    slots = (1, caps.max_activities, caps.max_timers, caps.max_children,
             caps.max_request_cancels, caps.max_signals_ext)
    widths = (S.X_N, S.AC_N, S.TI_N, S.CH_N, S.RC_N, S.SG_N)
    offs = R._slabs(lanes, slots[1:])
    assert offs[0] == 0 and 4 * offs[-1] == plan["smem_bytes"]
    for lo, hi, n, w in zip(offs, offs[1:], slots, widths):
        assert lo % 4 == 0 and lanes * n * w <= hi - lo < lanes * n * w + 4


def test_refresh_plan_refuses_tables_past_shared_memory():
    with pytest.raises(ValueError, match="do not fit shared memory"):
        R.refresh_plan(S.Capacities(max_activities=4000))


def _cpu_state(b=8):
    return S.state_from_numpy(crafted_state(3, b, RETRY_CAPS), "cpu")


@pytest.mark.parametrize("fault,match", [
    ("non_contiguous", "activities must be contiguous"),
    ("dtype", "timers must be int32"),
    ("batch", r"children must be \[8, n, 8\]"),
    ("fields", r"signals must be \[8, n, 4\]"),
    ("numpy", "cancels must be a torch tensor"),
])
def test_refresh_operand_checks_refuse(fault, match):
    """The kernel's operands: six contiguous int32 tables on one device,
    their batch and field widths agreeing."""
    st = _cpu_state()
    assert R.check_refresh_operands(st) == (8, 4, 2, 2, 2, 2)
    if fault == "non_contiguous":
        st.activities = st.activities.transpose(0, 1).contiguous(
        ).transpose(0, 1)
    elif fault == "dtype":
        st.timers = st.timers.to(torch.int64)
    elif fault == "batch":
        st.children = st.children[:7]
    elif fault == "fields":
        st.signals = st.signals[:, :, :3].contiguous()
    else:
        st.cancels = st.cancels.numpy()
    with pytest.raises(ValueError, match=match):
        R.check_refresh_operands(st)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors run ``refresh_tasks_plain``: no kernel library loaded,
    no launch counted, the same arrays."""
    def no_library(name):
        raise AssertionError(f"the CPU route loaded {name}")

    monkeypatch.setattr(_build, "load", no_library)
    st = _cpu_state(64)
    before = refresh_tasks_device.launches
    got = refresh_tasks_device(st)
    assert refresh_tasks_device.launches == before
    want = R.refresh_tasks_plain(st)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


REFRESH_CU = (Path(__file__).resolve().parents[1]
              / "cadence_tpu_torch/ops/csrc/refresh_tasks.cu")


def test_refresh_signature_passes_pointers_and_stream_as_void_p():
    """ctypes passes each of the C entry's pointers and its stream as a
    c_void_p (a c_int would cut a 64-bit pointer), each int as a c_int."""
    assert "refresh_tasks" in _build.KERNELS
    restype, args = _build._SIGNATURES["refresh_tasks"][
        "cadence_refresh_tasks"]
    assert restype is ctypes.c_int
    src = REFRESH_CU.read_text()
    proto = src[src.index("int cadence_refresh_tasks("):]
    params = [p.strip() for p in
              proto[proto.index("(") + 1:proto.index(")")].split(",")]
    assert len(params) == len(args) == 34
    for p, a in zip(params, args):
        assert a is (ctypes.c_void_p if "*" in p else ctypes.c_int), p
    assert params[-2] == "void* stream"


def test_refresh_kernel_source_matches_schema():
    """The kernel spells out the columns it reads, the sentinels and the
    output order; keep them in step with Python."""
    src = REFRESH_CU.read_text()
    consts = re.findall(r"\b((?:X|AC|TI|CH)_[A-Z0-9_]+) = (-?\d+)", src)
    assert len(consts) >= 25
    for name, value in consts:
        assert getattr(S, name) == int(value), name
    assert f"EMPTY_EVENT_ID = {EMPTY_EVENT_ID};" in src
    assert S.RC_OCC == S.SG_OCC == 0 and "EXT_OCC = 0" in src
    assert S.RC_INITIATED_ID == S.SG_INITIATED_ID == 2
    assert "EXT_INITIATED_ID = 2" in src and S.RC_N == S.SG_N == 4
    body = src[src.index("struct Outs {"):]
    body = body[:body.index("};")]
    assert re.findall(r"\* (\w+);", body) == list(FIELDS)


def test_refresh_makes_no_host_synchronisation():
    """The pass runs on meta tensors, which hold no values: it reads no
    value on the host (no ``.item()``, no copy, no branch on a tensor)."""
    st = crafted_state(9, 64, RETRY_CAPS)
    meta = S.StateTensors(**{
        f: torch.empty(getattr(st, f).shape, dtype=torch.int32,
                       device="meta") for f in S.STATE_ROW_FIELDS})
    got = refresh_tasks_device(meta)
    cpu = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    for f in FIELDS:
        g, c = getattr(got, f), getattr(cpu, f)
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (c.shape, c.dtype), f


def test_refresh_refuses_numpy_state():
    st = crafted_state(0, 4, SMALL_CAPS)
    with pytest.raises(TypeError, match="torch state"):
        refresh_tasks_device(st)


def test_refreshed_to_numpy_keeps_values_and_dtypes():
    st = crafted_state(5, 33, RETRY_CAPS)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    host = refreshed_to_numpy(got)
    for f in FIELDS:
        h, g = getattr(host, f), getattr(got, f)
        assert isinstance(h, np.ndarray) and h.shape == tuple(g.shape), f
        assert h.dtype == (np.bool_ if f in BOOL_FIELDS else np.int32), f
        np.testing.assert_array_equal(h, g.numpy(), err_msg=f)
    empty = refreshed_to_numpy(refresh_tasks_device(
        S.state_from_numpy(S.empty_state(0, RETRY_CAPS), "cpu")))
    assert empty.activity_timer.shape == (0, 5)


# -- hydration ---------------------------------------------------------------


def port_batches(batches):
    """The reference package's events as the port's, through to_dict."""
    return [[HistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in batches]


def task_dicts(tasks):
    """Tasks field by field, enums as ints."""
    return [{k: int(v) if k == "task_type" else v
             for k, v in dataclasses.asdict(t).items()} for t in tasks]


def transfer_keys(tasks):
    return [(int(t.task_type), t.schedule_id, t.task_list, t.initiated_id)
            for t in tasks]


def timer_keys(tasks):
    return [(int(t.task_type), t.visibility_timestamp, t.timeout_type,
             t.event_id, t.schedule_attempt, t.version) for t in tasks]


def port_oracle(batches):
    ms = MutableState(domain_id="dom")
    ms.version_histories = VH.VersionHistories.new_empty()
    ids = itertools.count()
    StateBuilder(ms, id_generator=lambda: f"id-{next(ids)}").apply_batches(
        "dom", "req", "wf", "run", batches)
    return ms


@pytest.mark.parametrize("scenario", ALL_SCENARIOS, ids=lambda f: f.__name__)
def test_hydrate_matches_reference_and_host_refresher(scenario):
    batches = scenario()
    jpk = JP.pack_histories([("wf", "run", batches)])
    j_tr, j_ti = JR.hydrate_tasks(
        JR.refreshed_to_numpy(JR.refresh_tasks_device_jit(
            j_replay_packed(jpk))), 0, jpk, domain_id="dom")

    pb = port_batches(batches)
    pk = P.pack_histories([("wf", "run", pb)])
    final = replay_packed(pk, device="cpu")
    tr, ti = hydrate_tasks(refresh_tasks_device(
        S.state_from_numpy(final, "cpu")), 0, pk, domain_id="dom")
    assert task_dicts(tr) == task_dicts(j_tr)
    assert task_dicts(ti) == task_dicts(j_ti)

    h_tr, h_ti = refresh_tasks(port_oracle(pb))
    assert transfer_keys(tr) == transfer_keys(h_tr)
    assert timer_keys(ti) == timer_keys(h_ti)


def test_hydrate_backoff_and_targets_match_reference():
    """Crafted rows hydrated with side tables that carry a first-decision
    backoff deadline, task lists and external targets: the same records
    as the reference's ``hydrate_tasks`` on the same arrays."""
    caps = RETRY_CAPS
    st = crafted_state(11, 64, caps)
    epoch_s = 1_700_000_000
    sides, j_sides = [], []
    for b in range(64):
        kw = dict(
            task_list=f"tl-{b % 3}",
            first_decision_backoff_deadline=(
                0 if b % 4 == 0 else (epoch_s + 3 * (b % 5)) * 10**9),
            activity_task_lists={s: f"atl-{s}" for s in range(b % 3)},
            child_domains={0: "cdom"}, child_workflow_ids={0: f"c-{b}"},
            cancel_targets={0: ("", f"x-{b}", "r", bool(b % 2))},
            signal_targets={1: ("sdom", f"y-{b}", "", False)})
        sides.append(P.WorkflowSideTable(**kw))
        j_sides.append(JP.WorkflowSideTable(**kw))
    got = refreshed_to_numpy(
        refresh_tasks_device(S.state_from_numpy(st, "cpu")))
    want = j_refresh(st)
    pk = SimpleNamespace(epoch_s=epoch_s, side=sides)
    jpk = SimpleNamespace(epoch_s=epoch_s, side=j_sides)
    n_backoff = 0
    for b in range(64):
        tr, ti = hydrate_tasks(got, b, pk, domain_id="dom")
        j_tr, j_ti = JR.hydrate_tasks(want, b, jpk, domain_id="dom")
        assert task_dicts(tr) == task_dicts(j_tr), b
        assert task_dicts(ti) == task_dicts(j_ti), b
        n_backoff += sum(t.task_type == TimerTaskType.WorkflowBackoffTimer
                         for t in ti)
    assert n_backoff, "some row re-arms the backoff timer"


# -- the replay + refresh step ------------------------------------------------


def test_replay_and_refresh_step_matches_reference():
    """``replay_scan_teb`` then ``refresh_tasks_device`` on the CPU equal
    the reference's ``replay_scan`` then ``refresh_tasks_device`` on the
    same pack (bench.py's unpacked replay step)."""
    caps = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                        max_children=2, max_request_cancels=2,
                        max_signals_ext=2, max_version_items=2)
    rng = random.Random(3)
    fz = HistoryFuzzer(seed=17, caps=caps)
    hs = [(f"r-{i}", f"run-{i}", W.retry_deep_history(rng, depth=200))
          for i in range(5)]
    hs += [(f"f-{i}", f"run-f{i}", fz.generate(target_events=150,
                                               close=i == 0))
           for i in range(3)]
    pk = P.pack_histories(hs, caps=caps)
    jcaps = JS.Capacities(**dataclasses.asdict(caps))
    jpk = JP.pack_histories(_reference_histories(hs), caps=jcaps)
    assert pk.events.tobytes() == jpk.events.tobytes()

    j_final = j_replay_scan(
        JS.empty_state(len(hs), jcaps), jnp.asarray(jpk.time_major()))
    want = JR.refreshed_to_numpy(JR.refresh_tasks_device_jit(j_final))

    final = RC.replay_scan_teb(
        S.state_from_numpy(S.empty_state(len(hs), caps), "cpu"),
        S.host_tensor(pk.teb()), caps)
    got = refresh_tasks_device(final)
    assert_refreshed_equal(got, want)
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(j_final, f)),
                                      err_msg=f)


def _reference_histories(hs):
    """The port's histories as the reference package's events."""
    from cadence_tpu.core.events import HistoryEvent as JHistoryEvent

    return [(w, r, [[JHistoryEvent.from_dict(e.to_dict()) for e in b]
                    for b in batches]) for w, r, batches in hs]
