"""The port's replication planes against the reference package's.

Same inputs through both packages, on the CPU (``device="cpu"`` for the
port): the sidecar's tensor codec and id hash byte for byte; the
checkpoint wire codec (rows decoded from each package's blob equal, the
fingerprint set alike: the port's covers its CUDA sources); the
24-workflow conflict storm of ``tests/test_replication_storm.py``; a deep
storm of 8 retry_deep histories with a divergent tail; the two-cluster
scenario of ``tests/test_xdc_replication.py`` on a frozen clock (standby
histories and persisted snapshots equal after first-seen uuid renaming);
the admin raw-history verb. Then the port's own rules: a fault of the
device replay raises out of each of the three replication rebuild sites
(the batched drain, the snapshot server, the snapshot installer) while a
packer refusal keeps the reference's fallback, and a history service
given no device rebuilds on the card.
"""

from __future__ import annotations

import functools
import json
import random

import numpy as np
import pytest
import torch

from tests.test_torch_replication_cases import _load
from tests.test_torch_service import _Renamer

DEEP_N, DEEP_DEPTH, DEEP_SEED, DEEP_VERSION = 8, 200, 45, 12


# -- the sidecar's codec and hash ---------------------------------------


def _codec_inputs():
    rng = np.random.default_rng(7)
    return {
        "empty": np.zeros(0, np.int32),
        "one": np.array([123456], np.int32),
        "extremes": np.array([-2**31, 2**31 - 1, -2**31, 0, -1, 2**31 - 1,
                              2**31 - 1, -2**31], np.int32),
        "random": rng.integers(-2**31, 2**31, 100_000,
                               dtype=np.int64).astype(np.int32),
        "monotone": np.cumsum(rng.integers(0, 50, 5_000)).astype(np.int32),
        "matrix": rng.integers(-9, 9, (37, 11)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def natives():
    from cadence_tpu import native as J
    from cadence_tpu_torch import native as N

    if N._load() is None:
        pytest.skip(f"no compiled sidecar: {N.load_error}")
    return J, N


@pytest.mark.parametrize("name", sorted(_codec_inputs()))
def test_tensor_codec_bytes_equal_reference(natives, name):
    J, N = natives
    arr = _codec_inputs()[name]
    want, shape = J.tensor_compress(arr)
    assert J.tensor_compress(arr, force_python=True)[0] == want
    for force in (False, True):
        blob, got_shape = N.tensor_compress(arr, force_python=force)
        assert blob == want, (name, force)
        assert tuple(got_shape) == tuple(shape)
        for dec_force in (False, True):
            back = N.tensor_decompress(blob, arr.shape,
                                       force_python=dec_force)
            assert back.dtype == np.int32
            np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("force", [False, True])
def test_tensor_codec_rejects_torn_blobs(natives, force):
    _, N = natives
    arr = _codec_inputs()["random"][:1000]
    blob, shape = N.tensor_compress(arr)
    for bad, bad_shape in ((blob[:-1], shape), (blob[: len(blob) // 2], shape),
                           (b"", shape), (b"\xff" * 8, shape),
                           (blob, (len(arr) + 1,))):
        with pytest.raises(ValueError):
            N.tensor_decompress(bad, bad_shape, force_python=force)


def test_fnv1a32_batch_equals_reference(natives):
    J, N = natives
    rng = random.Random(3)
    ids = [f"wf-{rng.randrange(1 << 40)}-{i}" for i in range(990)]
    ids += ["", "ü", "日本語-run", "emoji-\U0001f600", "a" * 300,
            "tab\tnewline\n", "ñandú", "Ω≈ç√", "x", "0"]
    want = J.fnv1a32_batch(ids)
    for force in (False, True):
        got = N.fnv1a32_batch(ids, force_python=force)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


# -- the checkpoint wire codec ------------------------------------------


def test_checkpoint_wire_rows_equal_reference():
    import tests.test_replication_transport as JT
    from cadence_tpu.runtime.replication import transport as jt
    from cadence_tpu_torch.runtime.replication import transport as pt

    PT = _load("test_replication_transport")
    j_ckpt = JT._stored_checkpoint()
    p_ckpt = PT["_stored_checkpoint"]()
    j_blob, p_blob = jt.encode_checkpoint_wire(j_ckpt), \
        pt.encode_checkpoint_wire(p_ckpt)
    decoded = [pt.decode_checkpoint_wire(j_blob),
               pt.decode_checkpoint_wire(p_blob),
               jt.decode_checkpoint_wire(p_blob)]
    rows = []
    for ck in decoded:
        d = json.loads(ck.to_json())
        d["fingerprint"] = "-"
        # the branch key and tree id carry each run's random uuid, the
        # write time the wall clock
        d.pop("branch_key"), d.pop("tree_id"), d.pop("created_at")
        rows.append(d)
    assert rows[0] == rows[1] == rows[2]
    assert rows[0]["state_row"]["exec_info"], "an empty state row"
    assert decoded[1].to_json() == p_ckpt.to_json()


# -- storms through both packages ---------------------------------------


def _spy(rb, record):
    many, one = rb.rebuild_many, rb.rebuild

    def spy_many(reqs, use_device=True):
        record.append(("many", len(reqs), use_device))
        return many(reqs, use_device=use_device)

    def spy_one(req):
        record.append(("one", 1, False))
        return one(req)

    rb.rebuild_many, rb.rebuild = spy_many, spy_one


def test_storm_24_equal_reference():
    import tests.test_replication_storm as JS

    PS = _load("test_replication_storm")
    j_rec, p_rec = [], []
    want = JS._run_storm(24, record=j_rec)
    got = PS["_run_storm"](24, record=p_rec)
    assert got == want
    assert j_rec == p_rec == [("many", 24, True)]
    assert PS["_run_sequential"](24) == got


def _deep_histories():
    from cadence_tpu_torch.testing import workloads as W

    rng = random.Random(DEEP_SEED)
    return [(f"wf-deep-{i}", f"run-deep-{i}",
             W.retry_deep_history(rng, v=1, depth=DEEP_DEPTH))
            for i in range(DEEP_N)]


def _to_reference(tasks):
    from cadence_tpu.core.events import HistoryEvent
    from cadence_tpu.runtime.replication import HistoryTaskV2

    return [HistoryTaskV2(
        task_id=t.task_id, domain_id=t.domain_id, workflow_id=t.workflow_id,
        run_id=t.run_id, version_history_items=t.version_history_items,
        events=[HistoryEvent.from_dict(e.to_dict()) for e in t.events],
    ) for t in tasks]


def _deep_storm(mod, convert):
    """Seed the deep histories page by page, then drain the storm cycle;
    returns (snapshots, rebuild calls of the storm cycle)."""
    from cadence_tpu_torch.testing.replication_storm import (
        BacklogClient,
        conflict_storm,
    )

    hs = _deep_histories()
    box = mod["Box"]()
    try:
        seed, storm = conflict_storm(box.domain_id, hs, DEEP_VERSION)
        client = BacklogClient(convert(seed), page=64)
        proc = mod["ReplicationTaskProcessor"](
            box.engine.shard, box.engine.ndc_replicator,
            mod["ReplicationTaskFetcher"]("active", client))
        assert proc.drain_tasks(max_rounds=1000) == len(seed)
        record = []
        _spy(box.engine.ndc_replicator.rebuilder, record)
        client.extend(convert(storm))
        assert proc.drain_tasks() == len(storm)
        return mod["_snapshot_all"](box, [(w, r) for w, r, _ in hs]), record
    finally:
        box.stop()


def test_deep_storm_equal_reference():
    import tests.test_replication_storm as JS

    PS = _load("test_replication_storm")
    want, j_rec = _deep_storm(vars(JS), _to_reference)
    got, p_rec = _deep_storm(PS, list)
    assert j_rec == p_rec == [("many", DEEP_N, True)]
    assert got == want
    for wf, (snap, vhs) in got.items():
        # every workflow ends on the forked branch, at the new version
        cur = vhs["histories"][vhs["current_index"]]["items"]
        assert cur[-1][1] == DEEP_VERSION, wf


# -- the two-cluster scenario on a frozen clock -------------------------


def _xdc_scenario(mod):
    clock = mod["FakeTimeSource"]()
    mod["HistoryService"] = functools.partial(mod["HistoryService"],
                                              time_source=clock)
    h = mod["Harness"]()
    Decision, DT = mod["Decision"], mod["DecisionType"]
    try:
        runs = {}
        for i in range(6):
            wf = f"wf-x{i}"
            runs[wf] = mod["_start"](h.active, wf, task_list=f"tl-{i}")
        h.replicate_all()
        for i in range(6):
            h.active.history_client.signal_workflow_execution(
                mod["SignalRequest"](
                    domain=mod["DOMAIN"], workflow_id=f"wf-x{i}",
                    signal_name=f"s{i}", input=b"x" * i, identity="t"))
        for i in (0, 2, 5):
            mod["_decide"](h.active, f"tl-{i}", [Decision(
                DT.CompleteWorkflowExecution, {"result": b"done"})])
        assert h.active.history.drain_queues()
        h.replicate_all()
        out = {}
        ex = h.standby.persistence.execution
        for wf, run in sorted(runs.items()):
            events = mod["_standby_history"](h, wf, run)
            shard = h.standby.history.controller.get_engine(wf).shard
            resp = ex.get_workflow_execution(shard.shard_id,
                                             h.standby.domain_id, wf, run)
            out[wf] = ([e.to_dict() for e in events], resp.snapshot)
        return out
    finally:
        h.stop()


def _xdc(port):
    from cadence_tpu.utils.clock import FakeTimeSource as JF
    from cadence_tpu_torch.utils.clock import FakeTimeSource as PF

    mod = _load("test_xdc_replication", port=port)
    mod["FakeTimeSource"] = PF if port else JF
    return mod


def test_xdc_scenario_equal_reference():
    want = _Renamer()(_xdc_scenario(_xdc(False)))
    got = _Renamer()(_xdc_scenario(_xdc(True)))
    assert got == want


def test_admin_raw_history_equal_reference():
    from cadence_tpu.frontend import AdminHandler as JA
    from cadence_tpu_torch.frontend import AdminHandler as PA

    outs = []
    for mod, admin_cls in (
            (_xdc(False), JA), (_xdc(True), PA)):
        clock = mod["FakeTimeSource"]()
        mod["HistoryService"] = functools.partial(mod["HistoryService"],
                                                  time_source=clock)
        c = mod["Cluster"]("active", "dom-raw-0000", "active")
        try:
            run = mod["_start"](c, "wf-raw")
            admin = admin_cls(c.history, c.domains)
            batches, items = admin.get_workflow_execution_raw_history(
                mod["DOMAIN"], "wf-raw", run)
            part, _ = admin.get_workflow_execution_raw_history(
                mod["DOMAIN"], "wf-raw", run, 2, 3)
            outs.append(_Renamer()((
                [[e.to_dict() for e in b] for b in batches], items,
                [[e.to_dict() for e in b] for b in part])))
        finally:
            c.stop()
    assert outs[0] == outs[1]
    assert outs[1][0], "the raw read returned no batch"


# -- no fallback that hides the device ----------------------------------


class _DeviceFault(RuntimeError):
    pass


def _raising(exc):
    def fn(*a, **kw):
        raise exc
    return fn


def test_batched_drain_device_fault_raises():
    from cadence_tpu_torch.ops.pack import PackError

    PS = _load("test_replication_storm")
    for exc, raises in ((_DeviceFault("kernel launch failed"), True),
                        (PackError("over capacity"), False)):
        box = PS["Box"]()
        try:
            tasks, _ = PS["_storm_tasks"](box.domain_id, 4)
            proc = PS["ReplicationTaskProcessor"](
                box.engine.shard, box.engine.ndc_replicator,
                PS["ReplicationTaskFetcher"]("active",
                                             PS["_QueueClient"](tasks)))
            rb = box.engine.ndc_replicator.rebuilder
            hosted = []
            host = rb.rebuild
            rb.rebuild_many = _raising(exc)
            rb.rebuild = lambda req: hosted.append(req) or host(req)
            if raises:
                with pytest.raises(_DeviceFault):
                    proc.process_once()
                assert hosted == []
            else:
                # the reference's fallback: one task at a time, each
                # conflict rebuilt on the host
                assert proc.process_once() == len(tasks)
                assert len(hosted) == 4
        finally:
            box.stop()


def _active_with_run():
    PX = _load("test_xdc_replication")
    h = PX["Harness"]()
    run = PX["_start"](h.active, "wf-snap")
    PX["_decide"](h.active, "tl", [])
    return PX, h, run


def test_snapshot_serve_device_fault_raises():
    from cadence_tpu_torch.ops.pack import PackError

    PX, h, run = _active_with_run()
    try:
        svc = h.active.history
        dom = h.active.domain_id
        queue = svc.controller.get_engine("wf-snap").replicator_queue
        rb, _ = queue._snapshot_serving()
        real = rb.rebuild_many
        rb.rebuild_many = _raising(_DeviceFault("device fault"))
        with pytest.raises(_DeviceFault):
            svc.get_replication_checkpoint(dom, "wf-snap", run)
        rb.rebuild_many = _raising(PackError("over capacity"))
        assert svc.get_replication_checkpoint(dom, "wf-snap", run) == b""
        rb.rebuild_many = real
        assert svc.get_replication_checkpoint(dom, "wf-snap", run) != b""
    finally:
        h.stop()


def test_snapshot_install_device_fault_raises():
    from cadence_tpu_torch.ops.pack import PackError
    from cadence_tpu_torch.runtime.replication.transport import (
        decode_checkpoint_wire,
    )

    PX, h, run = _active_with_run()
    try:
        dom = h.active.domain_id
        ckpt = decode_checkpoint_wire(
            h.active.history.get_replication_checkpoint(dom, "wf-snap", run))
        ndc = h.standby.history.controller.get_engine(
            "wf-snap").ndc_replicator
        rb, _ = ndc._snapshot_rebuilder()
        real = rb.rebuild_many
        rb.rebuild_many = _raising(_DeviceFault("device fault"))
        with pytest.raises(_DeviceFault):
            ndc.apply_state_snapshot(dom, "wf-snap", run, ckpt)
        rb.rebuild_many = _raising(PackError("over capacity"))
        assert ndc.apply_state_snapshot(dom, "wf-snap", run, ckpt) is None
        rb.rebuild_many = real
        res = ndc.apply_state_snapshot(dom, "wf-snap", run, ckpt)
        assert res is not None and res["covered_through"] == ckpt.event_id
    finally:
        h.stop()


class _TornLink:
    """The active's service, with every snapshot blob cut in half."""

    def __init__(self, svc):
        self._svc = svc

    def get_replication_checkpoint(self, *a):
        raw = self._svc.get_replication_checkpoint(*a)
        return raw[: len(raw) // 2]

    def __getattr__(self, name):
        return getattr(self._svc, name)


@pytest.mark.parametrize("side,exc", [
    ("serve", ValueError), ("serve", _DeviceFault),
    ("install", ValueError), ("install", _DeviceFault),
    ("torn", None),
])
def test_rereplicate_snapshot_device_fault_raises(side, exc):
    """Through ``HistoryRereplicator.rereplicate`` in snapshot mode: a
    fault of either side's device rebuild, a ``ValueError`` as the
    kernel wrappers raise one included, raises out of the heal; a torn
    blob falls back to event shipping and heals the gap."""
    from cadence_tpu_torch.runtime.replication import (
        MODE_SNAPSHOT, AdaptiveTransport, HistoryRereplicator,
        RetryTaskV2Error,
    )

    PX, h, run = _active_with_run()
    try:
        svc, dom = h.active.history, h.active.domain_id
        ndc = h.standby.history.controller.get_engine(
            "wf-snap").ndc_replicator
        if side == "serve":
            rb, _ = svc.controller.get_engine(
                "wf-snap").replicator_queue._snapshot_serving()
        else:
            rb, _ = ndc._snapshot_rebuilder()
        if exc is not None:
            rb.rebuild_many = _raising(exc("device fault"))
        client = _TornLink(svc) if side == "torn" else svc
        rr = HistoryRereplicator(
            client, ndc,
            transport=AdaptiveTransport(client, "active",
                                        force_mode=MODE_SNAPSHOT))
        tip = svc.get_workflow_history_raw(
            dom, "wf-snap", run, 1, 1 << 60)[0][-1][-1].event_id
        err = RetryTaskV2Error("gap", domain_id=dom, workflow_id="wf-snap",
                               run_id=run, start_event_id=0,
                               end_event_id=tip + 1)
        if exc is not None:
            with pytest.raises(exc, match="device fault"):
                rr.rereplicate(err)
            return
        assert rr.rereplicate(err) > 0  # healed by event shipping
        got = h.standby.history.get_workflow_history_raw(
            dom, "wf-snap", run, 1, 1 << 60)[0]
        assert got[-1][-1].event_id == tip
    finally:
        h.stop()


def test_history_service_replication_defaults_to_cuda():
    """Without ``device`` the replication planes rebuild on the card: on
    a host without one the first device rebuild raises, with no host
    route."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest,
    )

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    PX = _load("test_xdc_replication")
    h = PX["Harness"]()
    try:
        run = PX["_start"](h.active, "wf-cuda")
        PX["HistoryService"] = PX["HistoryService"].func  # no device
        c = PX["Cluster"]("standby", h.active.domain_id, "active")
        try:
            engine = c.history.controller.get_engine("wf-cuda")
            assert c.history.device == "cuda"
            assert engine.ndc_replicator.rebuilder.device == "cuda"
            assert engine.replicator_queue.device == "cuda"
            branch = h.active.history.controller.get_engine(
                "wf-cuda").replicator_queue
            ctoken = h.active.persistence.execution.get_workflow_execution(
                branch.shard.shard_id, h.active.domain_id, "wf-cuda",
                run).snapshot["execution_info"]["branch_token"]
            req = RebuildRequest(h.active.domain_id, "wf-cuda", run,
                                 ctoken.encode() if isinstance(ctoken, str)
                                 else ctoken)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                engine.ndc_replicator.rebuilder.rebuild_many([req])
        finally:
            c.stop()
    finally:
        h.stop()


# -- the reference bench's replication cells ----------------------------


def test_replication_cells_equal_reference():
    """The port's copies of bench.py's replication_lag and failover_drill
    cells against the reference's, at a small size on the CPU: every
    count equal, and the bytes of the arms that ship no snapshot (a
    snapshot's wire blob carries its write time as a float, whose
    digits vary; the adaptive arm's mode follows the host's timing)."""
    import bench
    from cadence_tpu_torch.testing import replication_cells as C

    j = bench._bench_replication_lag(3, 6, 65536.0)
    p = C.replication_lag(3, 6, 65536.0, device="cpu")
    keys = {
        "events": [k for k in j["events"] if not k.endswith("_s")],
        "snapshot": ["backlog_events", "converged", "mode_switches",
                     "snapshots_shipped", "events_replayed_saved"],
        "adaptive": ["backlog_events", "converged"],
    }
    for arm, ks in keys.items():
        assert {k: p[arm][k] for k in ks} == {k: j[arm][k] for k in ks}, arm
        assert p[arm]["converged"], arm
    assert p["snapshot"]["snapshots_shipped"] > 0
    j = bench._bench_failover_drill(2, 4, 65536.0)
    p = C.failover_drill(2, 4, 65536.0, device="cpu")
    for key in ("conflicts_resolved_total", "replication_lag_events_final",
                "bytes_shipped"):
        assert p[key] == j[key], key
    assert p["managed"]["drained_tasks"] == j["managed"]["drained_tasks"]
    assert p["slo"]["met"] and j["slo"]["met"]


def test_storm_beyond_the_cache_stays_one_rebuild():
    """More conflicts in one cycle than the history cache holds: every
    deferred workflow still completes from the one batched rebuild (its
    context pinned until then), none on the host, with the state of the
    one-at-a-time path. The reference's drain sends a workflow whose
    context the LRU dropped and the collector freed to the inline host
    rebuild."""
    import gc

    PS = _load("test_replication_storm")
    box = PS["Box"]()
    try:
        box.engine.cache._max = 8
        tasks, wfs = PS["_storm_tasks"](box.domain_id, 24)
        ndc = box.engine.ndc_replicator
        drain = ndc._drain_deferred

        def collected_drain(deferred, order):
            gc.collect()
            drain(deferred, order)
        ndc._drain_deferred = collected_drain
        record = []
        _spy(ndc.rebuilder, record)
        proc = PS["ReplicationTaskProcessor"](
            box.engine.shard, ndc,
            PS["ReplicationTaskFetcher"]("active", PS["_QueueClient"](tasks)))
        assert proc.drain_tasks() == len(tasks)
        got = PS["_snapshot_all"](box, wfs)
    finally:
        box.stop()
    assert record == [("many", 24, True)]
    assert got == PS["_run_sequential"](24)
