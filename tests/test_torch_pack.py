"""The port's host modules against the reference package: packer output
byte for byte, the workload copies, the narrow stream, import hygiene and
the device rule of the port's entry points."""

import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import replay_pallas as JRP
from cadence_tpu.ops import schema as JS
from cadence_tpu.testing import workloads as JW
from cadence_tpu.testing.event_generator import HistoryFuzzer

from cadence_tpu_torch.core.enums import (
    EventType, decision_attempt_increment,
)
from cadence_tpu_torch.ops import _build
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.testing import workloads as W

REPO = Path(__file__).resolve().parents[1]

CAPS = S.Capacities(
    max_events=1024, max_activities=4, max_timers=16, max_children=2,
    max_request_cancels=2, max_signals_ext=4, max_version_items=2,
)


def jcaps(caps):
    """The reference package's Capacities with the same sizes."""
    return JS.Capacities(**{f: getattr(caps, f)
                            for f in caps.__dataclass_fields__})


def _workload(gen_mod, name, n, seed=7):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if name == "echo":
            b = gen_mod.echo_history()
        elif name == "signal":
            b = gen_mod.signal_history(rng)
        elif name == "timer_storm":
            b = gen_mod.timer_storm_history(rng, depth=120)
        else:
            b = gen_mod.retry_deep_history(rng, depth=200)
        out.append((f"wf-{i}", f"run-{i}", b))
    return out


def _assert_packed_equal(a, b):
    assert a.events.dtype == b.events.dtype == np.int32
    np.testing.assert_array_equal(a.events, b.events)
    np.testing.assert_array_equal(a.lengths, b.lengths)
    assert a.epoch_s == b.epoch_s
    np.testing.assert_array_equal(a.teb(), b.teb())
    assert [s.to_dict() for s in a.side] == [s.to_dict() for s in b.side]


@pytest.mark.parametrize("name", ["echo", "signal", "timer_storm",
                                  "retry_deep"])
def test_pack_histories_matches_reference(name):
    """The port's workload copy gives the reference's histories, and its
    packer gives the reference packer's arrays, byte for byte."""
    hs = _workload(W, name, 6)
    jhs = _workload(JW, name, 6)
    got = P.pack_histories(hs, caps=CAPS)
    want = JP.pack_histories(jhs, caps=jcaps(CAPS))
    _assert_packed_equal(got, want)


@pytest.mark.parametrize("seg_align", [1, 8])
def test_pack_lanes_matches_reference(seg_align):
    hs = (_workload(W, "echo", 5) + _workload(W, "retry_deep", 3)
          + _workload(W, "signal", 4))
    jhs = (_workload(JW, "echo", 5) + _workload(JW, "retry_deep", 3)
           + _workload(JW, "signal", 4))
    got = P.pack_lanes(hs, caps=CAPS, target_lane_len=256,
                       seg_align=seg_align)
    want = JP.pack_lanes(jhs, caps=jcaps(CAPS), target_lane_len=256,
                         seg_align=seg_align)
    np.testing.assert_array_equal(got.events, want.events)
    np.testing.assert_array_equal(got.seg_end, want.seg_end)
    np.testing.assert_array_equal(got.out_row, want.out_row)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.reset_rows(), want.reset_rows())
    np.testing.assert_array_equal(got.teb(), want.teb())
    assert got.lane_segments == want.lane_segments
    assert got.present_types == want.present_types


def test_pack_fuzzed_histories_matches_reference():
    """Fuzzed histories (children, external cancels and signals, version
    bumps, resets) pack identically, reset points included."""
    caps = S.Capacities(max_events=96, max_activities=4, max_timers=4,
                        max_children=4, max_request_cancels=2,
                        max_signals_ext=2, max_version_items=4)
    fz = HistoryFuzzer(seed=11, caps=jcaps(caps))
    hs = [(f"wf-{i}", f"run-{i}", fz.generate(target_events=70))
          for i in range(12)]
    _assert_packed_equal(P.pack_histories(hs, caps=caps),
                         JP.pack_histories(hs, caps=jcaps(caps)))


@pytest.mark.parametrize("force_wide", [(), (S.EV_A2, S.EV_A5)])
def test_narrow_events_matches_reference(force_wide):
    rng = np.random.default_rng(3)
    ev = rng.integers(-500, 500, size=(12, S.EV_N, 40), dtype=np.int32)
    ev[:, S.EV_A0] = rng.integers(0, 2**31 - 1, size=(12, 40))  # hash-wide
    got = RC.narrow_events_teb(ev, force_wide=force_wide)
    want = JRP.narrow_events_teb(ev, force_wide=force_wide)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert S.EV_A0 in got[2] and set(force_wide) <= set(got[2])


def test_narrow_events_refuses_wide_gating_columns():
    ev = np.zeros((4, S.EV_N, 8), np.int32)
    ev[0, S.EV_SLOT, 0] = 2**20
    assert RC.narrow_events_teb(ev) is None
    assert RC.narrow_events_teb(ev[:, :, 1:], force_wide=(S.EV_TYPE,)) is None


def test_decision_attempt_increment_on_torch_bools():
    dfail = torch.tensor([True, False, False, False])
    dto = torch.tensor([False, True, True, False])
    a0 = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    got = decision_attempt_increment(dfail, dto, a0)
    assert got.tolist() == [True, True, False, False]


def test_state_carry_roundtrip():
    """state_from_numpy takes the reference package's StateTensors; the
    round trip through torch is lossless."""
    js = JS.empty_state(5, jcaps(CAPS))
    js.exec_info[:, S.X_SIGNAL_COUNT] = np.arange(5)
    st = S.state_from_numpy(js, "cpu")
    assert st.exec_info.dtype == torch.int32
    back = S.state_to_numpy(st)
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(js, f))


def test_rowmap_roundtrip():
    rm = RC.RowMap(CAPS)
    rng = np.random.default_rng(0)
    st = S.empty_state(7, CAPS).map(
        lambda a: rng.integers(-9, 9, size=a.shape, dtype=np.int32))
    rows = RC.state_to_rows(S.state_from_numpy(st, "cpu"), rm)
    assert rows.shape == (rm.rows_padded, 7)
    back = S.state_to_numpy(RC.rows_to_state(rows, rm))
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(back, f), getattr(st, f))


@pytest.mark.parametrize("caps,rows,lanes", [
    (S.Capacities(max_events=1024, max_activities=4, max_timers=2,
                  max_children=2, max_request_cancels=2, max_signals_ext=2,
                  max_version_items=2), 152, 128),
    (S.Capacities(), 944, 32),
])
def test_rowmap_sizes_and_block_lanes(caps, rows, lanes):
    """R_pad equals the reference kernel's, and the CUDA block's state
    tile fits shared memory."""
    assert RC.RowMap(caps).rows_padded == rows
    assert JRP.RowMap(jcaps(caps)).rows_padded == rows
    assert RC.lanes_per_block(rows) == lanes
    assert rows * 4 * lanes <= _build.H100.block_smem


def test_schema_constants_match_kernel_source():
    """The kernel source spells out the event-type codes, the column
    layout and the sentinels; keep them in step with the Python side."""
    from cadence_tpu_torch.core import ids

    src = (REPO / "cadence_tpu_torch/ops/csrc/replay_fsm.cu").read_text()
    for et in EventType:
        if et is EventType.UpsertWorkflowSearchAttributes:
            continue
        assert f"{et.name} = {int(et)}" in src, et.name
    # X_N is absent there: the kernel takes row offsets as parameters
    names = [n for n in dir(S) if n.split("_")[0] in
             ("EV", "X", "AC", "TI", "CH") and n != "X_N"
             and isinstance(getattr(S, n), int)]
    assert len(names) > 60
    for n in names:
        assert f"{n} = {getattr(S, n)}" in src, n
    for n in ("EMPTY_EVENT_ID", "EMPTY_VERSION"):
        assert f"{n} = {getattr(ids, n)};" in src, n
    assert S.RC_N == S.SG_N == 4 and "EXT_N = 4" in src


def test_import_hygiene():
    """Importing the port, the parallel-in-time replay and its scan
    kernel's wrapper, the rebuilder, the checkpoint plane, the serving
    plane, the device task refresh, the native sidecar, the history
    host (service, matching, clients), the frontend, the worker SDK,
    visibility, archival, the cluster metadata, the message bus, the
    replication planes, the standby queues, the wire codec, the link
    simulator, the parallel queue executor, resharding, the capacity
    autopilot, the conflict-matrix artifact, the trimmed config, the
    topology cells, the worker services and their daemons, the sqlite
    store, its schema and checkpoint store, the environment module, the
    onebox and serving-demo twins, and the server's entry points (the
    gRPC plane, the routed clients, the config loader and bootstrap, the
    template renderer, the operator CLI, the canary and the pprof
    endpoint), fault injection, the effect and race witnesses, the
    tracked locks and the static lock-order pass included, loads neither
    jax nor the reference package."""
    code = (
        "import sys\n"
        "import cadence_tpu_torch\n"
        "import cadence_tpu_torch.ops.dispatch, cadence_tpu_torch.ops.unpack\n"
        "import cadence_tpu_torch.ops.assoc, cadence_tpu_torch.ops.assoc_cuda\n"
        "import cadence_tpu_torch.testing.workloads\n"
        "import cadence_tpu_torch.testing.event_generator\n"
        "import cadence_tpu_torch.core.history_factory\n"
        "import cadence_tpu_torch.runtime.replication.rebuilder\n"
        "import cadence_tpu_torch.checkpoint\n"
        "import cadence_tpu_torch.serving, cadence_tpu_torch.utils.quotas\n"
        "import cadence_tpu_torch.ops.refresh, cadence_tpu_torch.native\n"
        "import cadence_tpu_torch.parallel, cadence_tpu_torch.entry\n"
        "import cadence_tpu_torch.runtime.service\n"
        "import cadence_tpu_torch.matching, cadence_tpu_torch.client\n"
        "import cadence_tpu_torch.frontend, cadence_tpu_torch.worker\n"
        "import cadence_tpu_torch.visibility, cadence_tpu_torch.archival\n"
        "import cadence_tpu_torch.cluster, cadence_tpu_torch.messaging\n"
        "import cadence_tpu_torch.testing.onebox\n"
        "import cadence_tpu_torch.testing.serve_demo\n"
        "import cadence_tpu_torch.runtime.replication\n"
        "import cadence_tpu_torch.runtime.queues.standby\n"
        "import cadence_tpu_torch.rpc, cadence_tpu_torch.testing.faults\n"
        "import cadence_tpu_torch.utils.task_processor\n"
        "import cadence_tpu_torch.runtime.queues.parallel\n"
        "import cadence_tpu_torch.runtime.resharding\n"
        "import cadence_tpu_torch.runtime.autopilot\n"
        "import cadence_tpu_torch.analysis.artifact\n"
        "import cadence_tpu_torch.config.static\n"
        "import cadence_tpu_torch.testing.topology_cells\n"
        "import cadence_tpu_torch.worker.service\n"
        "import cadence_tpu_torch.worker.archiver\n"
        "import cadence_tpu_torch.worker.scanner\n"
        "import cadence_tpu_torch.worker.batcher\n"
        "import cadence_tpu_torch.worker.parent_close_policy\n"
        "import cadence_tpu_torch.worker.indexer\n"
        "import cadence_tpu_torch.worker.replicator\n"
        "import cadence_tpu_torch.runtime.persistence.sqlite\n"
        "import cadence_tpu_torch.runtime.persistence.schema\n"
        "import cadence_tpu_torch.testing.environment\n"
        "from cadence_tpu_torch.checkpoint import SqliteCheckpointStore\n"
        "import cadence_tpu_torch.rpc.server, cadence_tpu_torch.rpc.client\n"
        "import cadence_tpu_torch.client.routed, cadence_tpu_torch.config\n"
        "import cadence_tpu_torch.config.bootstrap\n"
        "import cadence_tpu_torch.config.render\n"
        "import cadence_tpu_torch.tools.cli, cadence_tpu_torch.canary\n"
        "import cadence_tpu_torch.utils.pprof\n"
        "import cadence_tpu_torch.testing.race_witness\n"
        "import cadence_tpu_torch.testing.effect_witness\n"
        "import cadence_tpu_torch.analysis.lock_order\n"
        "import cadence_tpu_torch.analysis.findings\n"
        "import cadence_tpu_torch.utils.locks\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'cadence_tpu' or m.startswith('cadence_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_reference_imports_in_port_sources():
    banned = ("import jax", "from jax", "import cadence_tpu.",
              "from cadence_tpu ", "from cadence_tpu.")
    files = list((REPO / "cadence_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        text = path.read_text()
        for b in banned:
            assert b not in text, f"{path.name} contains {b!r}"


def test_entry_points_default_to_cuda():
    """Without device='cpu' an entry point needs CUDA and says so."""
    from cadence_tpu_torch.ops.dispatch import DeviceDispatcher, replay_stream
    from cadence_tpu_torch.ops.replay import replay_packed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    hs = _workload(W, "echo", 2)
    pk = P.pack_histories(hs, caps=CAPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay_packed(pk)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay_stream(hs, caps=CAPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceDispatcher(CAPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.state_from_numpy(S.empty_state(1, CAPS))


def test_onebox_serving_defaults_to_cuda():
    """The onebox twin's resident engine and the serving demo take the
    card by default: without one they raise, with no CPU fallback."""
    from cadence_tpu_torch.testing.onebox import Onebox
    from cadence_tpu_torch.testing.serve_demo import run_demo

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Onebox(serving=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_demo(quiet=True)


def test_kernel_build_needs_nvcc():
    """The CUDA kernels build at first use and only with nvcc; the
    library name follows the source, so an edit rebuilds."""
    import shutil

    from cadence_tpu_torch.ops import _build

    path = _build._lib_path("replay_fsm")
    assert path.parent == REPO / "build" / "torch_kernels"
    assert path.name.startswith("libreplay_fsm-")
    if shutil.which("nvcc") or (Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("nvcc is installed here")
    if path.exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("replay_fsm")
