"""The port's C++ sidecar (``cadence_tpu_torch.native``) against its numpy
paths, the reference package's sidecar and the port's plain FSM.

Skips only without ``g++``. The scatters must equal their
``force_python`` paths and the reference sidecar's output byte for byte
(ragged, empty and zero-width batches); inconsistent lengths raise before
a pointer reaches C; ``pack_histories`` gives the same bytes with and
without the library; ``replay_sequential`` equals the port's
``replay_packed(device="cpu")`` and the reference's compiled replayer on
the cases of ``tests/test_native_replayer.py``, and the plain FSM on
random events that reach the edge cases (version histories past
capacity, slots out of range, padding steps, decision-timeout
provenance)."""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cadence_tpu import native as jnative
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import schema as JS

from cadence_tpu_torch import native
from cadence_tpu_torch.core.enums import EventType as E
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

REPO = Path(__file__).resolve().parents[1]
# layout name -> (the port's scatter, the reference's, output axes)
SCATTERS = {
    "time_major": (native.scatter_time_major, jnative.scatter_time_major,
                   "tbe"),
    "teb": (native.scatter_teb, jnative.scatter_teb, "teb"),
    "batch_major": (native.scatter_batch_major,
                    jnative.scatter_batch_major, "bte"),
}


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the sidecar cannot be built")
    loaded = native._load()
    assert loaded is not None, native.load_error
    return loaded


def ragged(seed: int, batch: int, ev_n: int = S.EV_N, max_len: int = 24):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, size=batch)
    if batch:
        lengths[rng.integers(0, batch)] = max_len   # one full workflow
    rows = rng.integers(-(2**31), 2**31, size=(int(lengths.sum()), ev_n),
                        dtype=np.int64).astype(np.int32)
    return rows, lengths


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype == np.int32 and a.shape == b.shape
            and a.flags.c_contiguous and b.flags.c_contiguous
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("layout", sorted(SCATTERS))
@pytest.mark.parametrize("seed,batch,ev_n", [
    (0, 37, S.EV_N), (1, 1, S.EV_N), (2, 600, S.EV_N), (3, 9, 5),
    (4, 0, S.EV_N), (5, 7, 0),
], ids=["ragged", "one", "wide", "narrow-rows", "empty-batch", "ev_n-0"])
def test_scatter_matches_numpy_and_reference(lib, layout, seed, batch, ev_n):
    port, ref, _ = SCATTERS[layout]
    rows, lengths = ragged(seed, batch, ev_n)
    got = port(rows, lengths, 24)
    assert same_bytes(got, port(rows, lengths, 24, force_python=True))
    assert same_bytes(got, ref(rows, lengths, 24))


@pytest.mark.parametrize("layout", sorted(SCATTERS))
def test_scatter_pads_column_zero(lib, layout):
    port, _, axes = SCATTERS[layout]
    rows = np.arange(3 * S.EV_N, dtype=np.int32).reshape(3, S.EV_N) + 100
    out = port(rows, np.array([2, 0, 1]), 4)
    bte = np.transpose(out, [axes.index(a) for a in "bte"])
    np.testing.assert_array_equal(bte[0, :2], rows[:2])
    np.testing.assert_array_equal(bte[2, :1], rows[2:])
    for b, t in ((0, 2), (0, 3), (1, 0), (1, 3), (2, 1)):
        assert bte[b, t, 0] == -1 and not bte[b, t, 1:].any()


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("layout", sorted(SCATTERS))
def test_scatter_refuses_inconsistent_lengths(lib, layout, force_python):
    port = SCATTERS[layout][0]
    lengths = np.array([3, 0, 24, 5, 1])
    rows = np.ones((int(lengths.sum()), S.EV_N), np.int32)
    for lens, match in (([4, 0, 24, 5, 1], "sum"),
                        ([-1, 0, 24, 5, 5], "negative"),
                        ([3, 0, 25, 5, 0], "exceeds max_events")):
        with pytest.raises(ValueError, match=match):
            port(rows, np.array(lens), 24, force_python=force_python)
    with pytest.raises(ValueError, match="sum"):
        port(rows[:-1], lengths, 24, force_python=force_python)


def test_scatter_takes_any_int_buffers(lib):
    """int64 rows, int32 lengths and non-contiguous views are copied to
    C-contiguous int32 / int64 before any pointer reaches C."""
    rows, lengths = ragged(8, 11)
    wide = np.asfortranarray(rows.astype(np.int64))
    got = native.scatter_teb(wide, lengths.astype(np.int32), 24)
    assert same_bytes(got, native.scatter_teb(rows, lengths, 24,
                                              force_python=True))


def histories(seed, n, target, caps=None):
    fz = HistoryFuzzer(seed=seed, caps=caps)
    return [(f"wf-{i}", f"run-{i}", fz.generate(target_events=target))
            for i in range(n)]


def jcaps(caps):
    return JS.Capacities(**dataclasses.asdict(caps))


def test_pack_histories_same_bytes_with_and_without_the_library(
        lib, monkeypatch):
    caps = S.Capacities(max_events=256)
    hs = histories(31, 9, 80, caps)
    with_lib = P.pack_histories(hs, caps=caps, pad_batch_to=12)
    monkeypatch.setattr(native, "_load", lambda: None)
    without = P.pack_histories(hs, caps=caps, pad_batch_to=12)
    monkeypatch.undo()
    for f in ("events", "rows_concat", "lengths"):
        a, b = getattr(with_lib, f), getattr(without, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    teb = with_lib.teb()
    assert same_bytes(teb, np.ascontiguousarray(
        np.transpose(with_lib.events, (1, 2, 0))))
    assert not teb.flags.writeable and with_lib.teb() is teb
    assert same_bytes(with_lib.time_major(), np.ascontiguousarray(
        np.transpose(with_lib.events, (1, 0, 2))))
    # and the reference packer's bytes
    jpk = JP.pack_histories(hs, caps=jcaps(caps), pad_batch_to=12)
    assert with_lib.events.tobytes() == jpk.events.tobytes()


def assert_states_equal(a, b, what):
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            err_msg=f"{what}: {f}")


DEEP = S.Capacities(max_events=512)
# the cases of tests/test_native_replayer.py
PACK_CASES = {
    "small": lambda: [P.pack_histories(histories(11, 8, 40))],
    "sweep": lambda: [P.pack_histories(histories(seed, 6, 60))
                      for seed in (1, 2, 3, 4, 5)],
    "deep": lambda: [P.pack_histories(histories(77, 4, 400, DEEP),
                                      caps=DEEP)],
    "padded": lambda: [P.pack_histories(histories(21, 3, 25),
                                        pad_batch_to=8)],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_replay_sequential_matches_plain_fsm_and_reference(lib, case):
    for pk in PACK_CASES[case]():
        got = native.replay_sequential(pk)
        assert got.exec_info.dtype == np.int32
        assert_states_equal(got, replay_packed(pk, device="cpu"),
                            f"{case} against the plain FSM")
        assert_states_equal(got, jnative.replay_sequential(
            pk, caps=jcaps(pk.caps)), f"{case} against the reference")


def random_events(seed, b, t, caps):
    """[B, T, EV_N] int32 events over every event type: padding steps,
    slots from -1 to past every table, versions that change often (the
    version history outgrows its capacity), decision timeouts of both
    kinds."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, t, S.EV_N), np.int32)
    et = rng.integers(0, len(E), size=(b, t))
    et[rng.random((b, t)) < 0.1] = -1
    ev[:, :, S.EV_TYPE] = et
    ev[:, :, S.EV_ID] = np.arange(1, t + 1)
    ev[:, :, S.EV_VERSION] = rng.choice([-24, 1, 2, 3, 10], size=(b, t))
    ev[:, :, S.EV_TASK_ID] = rng.integers(-1234, 5000, size=(b, t))
    ev[:, :, S.EV_TS] = rng.integers(0, 30000, size=(b, t))
    ev[:, :, S.EV_BATCH_FIRST] = rng.integers(1, t + 1, size=(b, t))
    ev[:, :, S.EV_IS_BATCH_LAST] = rng.integers(0, 2, size=(b, t))
    top = max(caps.max_activities, caps.max_timers, caps.max_children,
              caps.max_request_cancels, caps.max_signals_ext)
    ev[:, :, S.EV_SLOT] = rng.integers(-1, top + 2, size=(b, t))
    ev[:, :, S.EV_A0:] = rng.integers(-3, 20, size=(b, t, S.EV_N - S.EV_A0))
    ev[:, :, S.EV_A0] = rng.integers(0, 2**31 - 1, size=(b, t))
    dto = et == int(E.DecisionTaskTimedOut)
    ev[:, :, S.EV_A0][dto] = rng.integers(0, 2, size=int(dto.sum()))
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_sequential_matches_plain_fsm_on_edge_cases(lib, seed):
    caps = S.Capacities(max_events=128, max_activities=3, max_timers=2,
                        max_children=2, max_request_cancels=2,
                        max_signals_ext=2, max_version_items=2)
    b, t = 64, 128
    ev = random_events(seed, b, t, caps)
    lengths = np.random.default_rng(seed + 50).integers(0, t + 1, size=b)
    # steps past a history's length are padding, as the packer writes them
    ev[np.arange(t)[None, :] >= lengths[:, None], S.EV_TYPE] = -1
    pk = P.PackedHistories(events=ev, lengths=lengths.astype(np.int32),
                           side=[P.WorkflowSideTable()] * b, caps=caps)
    got = native.replay_sequential(pk)
    final = RC.replay_scan_teb(
        S.state_from_numpy(S.empty_state(b, caps), "cpu"),
        torch.from_numpy(np.ascontiguousarray(ev.transpose(1, 2, 0))), caps)
    assert (got.vh_len > caps.max_version_items).any()
    assert_states_equal(got, S.state_to_numpy(final), "random events")


def test_replay_sequential_refuses_without_library_or_with_resume(
        lib, monkeypatch):
    pk = P.pack_histories(histories(3, 2, 30))
    resumed = dataclasses.replace(pk, initial=S.empty_state(2, pk.caps))
    with pytest.raises(ValueError, match="resumed"):
        native.replay_sequential(resumed)
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="no compiled baseline"):
        native.replay_sequential(pk)


def test_library_is_built_from_the_port_source_into_build(lib, tmp_path,
                                                          monkeypatch):
    """The library comes from cadence_tpu_torch/native/sidecar.cpp, never
    from native/, into the git-ignored build/torch_native/; its name
    follows the source, and it carries only what the port calls."""
    assert native.SRC == REPO / "cadence_tpu_torch" / "native" / "sidecar.cpp"
    path = native.lib_path()
    assert path.parent == REPO / "build" / "torch_native"
    assert Path(lib._name) == path and path.exists()
    assert native.HAVE_NATIVE
    for fn in ("ct_scatter_time_major", "ct_scatter_teb",
               "ct_scatter_batch_major", "ct_replay_sequential",
               "ct_fnv1a32_batch", "ct_compress_bound", "ct_tensor_compress",
               "ct_tensor_decompress", "ct_tensor_peek_count"):
        assert hasattr(lib, fn)
    assert not hasattr(lib, "ct_presence")
    edited = tmp_path / "sidecar.cpp"
    edited.write_bytes(native.SRC.read_bytes() + b"// edited\n")
    monkeypatch.setattr(native, "SRC", edited)
    assert native.lib_path() != path
