"""The port's host oracle against the reference package's: the history
fuzzer, the state builder and the task refresher, and version histories.

Every comparison is exact: the same seed gives the same events, and the
same events give the same state and tasks, field by field."""

import dataclasses
import itertools

import pytest

from cadence_tpu.core import version_history as JVH
from cadence_tpu.core.mutable_state import MutableState as JMutableState
from cadence_tpu.core.state_builder import StateBuilder as JStateBuilder
from cadence_tpu.core.task_refresher import refresh_tasks as j_refresh_tasks
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.unpack import (
    mutable_state_to_snapshot as j_mutable_state_to_snapshot,
)
from cadence_tpu.testing import workloads as JW
from cadence_tpu.testing.event_generator import (
    HistoryFuzzer as JHistoryFuzzer,
)

from cadence_tpu_torch.core import version_history as VH
from cadence_tpu_torch.core.events import HistoryEvent
from cadence_tpu_torch.core.mutable_state import MutableState
from cadence_tpu_torch.core.state_builder import StateBuilder
from cadence_tpu_torch.core.task_refresher import refresh_tasks
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
from cadence_tpu_torch.testing import workloads as W
from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

SMALL_CAPS = dict(max_events=256, max_activities=4, max_timers=3,
                  max_children=2, max_request_cancels=2, max_signals_ext=2,
                  max_version_items=3)


def to_dicts(batches):
    return [[e.to_dict() for e in b] for b in batches]


def port_batches(batches):
    """The reference package's events as the port's, through to_dict."""
    return [[HistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in batches]


def task_dicts(tasks):
    """Tasks field by field, enums as ints."""
    out = []
    for t in tasks:
        d = dataclasses.asdict(t)
        out.append({k: int(v) if k == "task_type" else v
                    for k, v in d.items()})
    return out


@pytest.mark.parametrize("seed,target,close,caps", [
    (0, 40, True, None),
    (7, 150, True, None),
    (23, 120, False, SMALL_CAPS),
    (101, 60, True, SMALL_CAPS),
])
def test_fuzzer_same_seed_same_events(seed, target, close, caps):
    jf = JHistoryFuzzer(seed=seed, caps=JS.Capacities(**caps)
                        if caps else None)
    pf = HistoryFuzzer(seed=seed, caps=S.Capacities(**caps)
                       if caps else None)
    for _ in range(3):   # successive histories from one fuzzer
        want = jf.generate(target_events=target, close=close)
        got = pf.generate(target_events=target, close=close)
        assert to_dicts(got) == to_dicts(want)


def test_ndc_storm_history_matches_reference():
    want = JW.ndc_storm_history(JHistoryFuzzer(seed=42), depth=150)
    got = W.ndc_storm_history(HistoryFuzzer(seed=42), depth=150)
    assert to_dicts(got) == to_dicts(want)


def _oracle(builder_cls, ms_cls, refresh, vh_mod, batches):
    """Replay on a host oracle. Request ids come from a counter, not
    uuid4, so two replays agree on them."""
    ms = ms_cls(domain_id="dom")
    ms.version_histories = vh_mod.VersionHistories.new_empty()
    ids = itertools.count()
    builder_cls(ms, id_generator=lambda: f"id-{next(ids)}").apply_batches(
        "dom", "req", "wf", "run", batches)
    transfer, timer = refresh(ms)
    return ms, transfer, timer


@pytest.mark.parametrize("seed", [3, 11, 29, 57])
def test_state_builder_and_refresh_match_reference(seed):
    """The host oracle and the task refresher, on the same fuzzed
    histories: the full MutableState snapshot, the canonical replay
    snapshot, and every transfer and timer task field by field."""
    jf = JHistoryFuzzer(seed=seed)
    for i in range(3):
        batches = jf.generate(target_events=40 + 50 * i, close=i != 1)
        j_ms, j_tr, j_ti = _oracle(JStateBuilder, JMutableState,
                                   j_refresh_tasks, JVH, batches)
        p_ms, p_tr, p_ti = _oracle(StateBuilder, MutableState,
                                   refresh_tasks, VH, port_batches(batches))
        assert p_ms.snapshot() == j_ms.snapshot()
        assert mutable_state_to_snapshot(p_ms) == \
            j_mutable_state_to_snapshot(j_ms)
        assert task_dicts(p_tr) == task_dicts(j_tr)
        assert task_dicts(p_ti) == task_dicts(j_ti)
        assert p_ti or p_tr, "a rebuilt run carries tasks"


def test_version_histories_round_trip_and_lca():
    """Version histories: dict round trips equal to the reference's, and
    the same LCA and appendability answers."""
    items_a = [(5, 10), (9, 20), (14, 40)]
    items_b = [(5, 10), (11, 20), (12, 30)]

    def build(mod, items):
        vh = mod.VersionHistory()
        for e, v in items:
            vh.add_or_update_item(e, v)
        return vh

    p_a, p_b = build(VH, items_a), build(VH, items_b)
    j_a, j_b = build(JVH, items_a), build(JVH, items_b)
    assert p_a.to_dict() == j_a.to_dict()
    assert VH.VersionHistory.from_dict(p_a.to_dict()).to_dict() == \
        p_a.to_dict()
    lca, jlca = p_a.find_lca_item(p_b), j_a.find_lca_item(j_b)
    assert (lca.event_id, lca.version) == (jlca.event_id, jlca.version)
    assert p_a.is_lca_appendable(lca) == j_a.is_lca_appendable(jlca)

    p_hs = VH.VersionHistories([p_a], 0)
    j_hs = JVH.VersionHistories([j_a], 0)
    assert p_hs.add_version_history(p_b) == j_hs.add_version_history(j_b)
    assert p_hs.to_dict() == j_hs.to_dict()
    idx, item = p_hs.find_lca_index_and_item(p_b)
    jidx, jitem = j_hs.find_lca_index_and_item(j_b)
    assert (idx, item.event_id, item.version) == \
        (jidx, jitem.event_id, jitem.version)
    back = VH.VersionHistories.from_dict(p_hs.to_dict())
    assert back.to_dict() == p_hs.to_dict()
    assert back.get_current_version_history().to_dict() == \
        p_hs.get_current_version_history().to_dict()
    with pytest.raises(VH.VersionHistoryError):
        p_a.add_or_update_item(3, 50)   # event ids must not go back
