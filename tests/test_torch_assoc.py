"""The port's parallel-in-time replay against the reference package, exactly.

``affine_segscan_plain`` (the plain PyTorch version of the CUDA segmented
affine-scan kernel, and what its wrapper runs for CPU tensors) is held
against the reference's ``lax.associative_scan`` form and its Pallas
kernel in interpret mode. The port's ``replay_assoc_fm`` /
``replay_assoc`` / ``replay_assoc_lanes`` (both impls) are held against
the reference's and against the port's own sequential replay, on fuzzed,
lane-packed, checkpoint-resumed and hybrid batches; the facades'
``scan_mode="assoc"`` against ``"scan"``. Every field is int32 and every
comparison exact.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.ops import assoc as JA
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.replay import replay_packed as j_replay_packed
from cadence_tpu.ops.replay import type_signature as j_type_signature
from cadence_tpu.ops.replay_pallas import affine_segscan_pallas
from cadence_tpu.testing import workloads as JW
from cadence_tpu.testing.event_generator import HistoryFuzzer

from cadence_tpu_torch.core import history_factory as F
from cadence_tpu_torch.core.enums import EventType as E
from cadence_tpu_torch.ops import assoc as A
from cadence_tpu_torch.ops import assoc_cuda as AC
from cadence_tpu_torch.ops import dispatch as D
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import (
    replay_packed, replay_packed_lanes, type_signature,
)
from cadence_tpu_torch.ops.unpack import state_row_to_snapshot
from cadence_tpu_torch.testing import workloads as W

CAPS = S.Capacities(
    max_events=96, max_activities=4, max_timers=4, max_children=4,
    max_request_cancels=2, max_signals_ext=2, max_version_items=4,
)
RETRY_CAPS = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                          max_children=2, max_request_cancels=2,
                          max_signals_ext=2, max_version_items=2)
IMPLS = ("resolve", "segscan")


def jcaps(caps):
    return JS.Capacities(**{f: getattr(caps, f)
                            for f in caps.__dataclass_fields__})


def assert_state_equal(got, want):
    """``got``: torch (any dtype checked int32) or numpy StateTensors."""
    for f in S.STATE_ROW_FIELDS:
        g = getattr(got, f)
        if isinstance(g, torch.Tensor):
            assert g.dtype == torch.int32, f"{f} is {g.dtype}"
            g = g.numpy()
        w = np.asarray(getattr(want, f))
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"field {f} diverged")


def fuzz(n, seed, target, caps=CAPS, close_every=3):
    out = []
    for i in range(n):
        fz = HistoryFuzzer(seed=seed + i, caps=jcaps(caps))
        out.append((f"wf-{i}", f"run-{i}",
                    fz.generate(target_events=target + (i % 4) * 8,
                                close=i % close_every != 0)))
    return out


def scan(pk, initial=None):
    """The port's sequential replay (FSM kernel's plain version)."""
    return replay_packed(pk, initial=initial, scan_mode="scan", device="cpu")


# --------------------------------------------------------------------------
# the segmented affine scan: plain version against the reference
# --------------------------------------------------------------------------


def _segscan_case(name):
    rng = np.random.default_rng(17)
    if name == "counter":
        # a pure counter stream (mul=1, add=1): prefix sums that a reset
        # restarts
        T, L, C = 16, 4, 1
        mul = np.ones((T, L, C), np.int32)
        add = np.ones((T, L, C), np.int32)
        rst = np.zeros((T, L), bool)
        rst[0] = True
        rst[8, 2] = True
        return mul, add, rst
    T = 45 if name == "T45" else 48
    L, C = 8, 5
    if name == "full_range":
        mul = rng.integers(-2**31, 2**31, (T, L, C), dtype=np.int64)
        add = rng.integers(-2**31, 2**31, (T, L, C), dtype=np.int64)
        mul, add = mul.astype(np.int32), add.astype(np.int32)
    else:
        mul = rng.integers(0, 2, (T, L, C), dtype=np.int32)
        add = rng.integers(-9, 99, (T, L, C), dtype=np.int32)
    rst = rng.random((T, L)) < 0.2
    rst[0] = True
    # one reset exactly at a block boundary of the TPU kernel's tb=8
    rst[16, 3] = True
    return mul, add, rst


@pytest.mark.parametrize("name", ["blocked", "T45", "full_range", "counter"])
def test_affine_segscan_plain_matches_reference(name):
    """affine_segscan_plain == the reference's associative-scan form and
    its Pallas kernel (interpret mode; tb divides T), bit for bit."""
    mul, add, rst = _segscan_case(name)
    T = mul.shape[0]
    got_m, got_a = AC.affine_segscan_plain(
        torch.from_numpy(mul), torch.from_numpy(add), torch.from_numpy(rst))
    assert got_m.dtype == got_a.dtype == torch.int32
    rst3 = np.broadcast_to(rst[:, :, None], mul.shape)
    want_m, want_a = JA.affine_segscan(jnp.asarray(mul), jnp.asarray(add),
                                       jnp.asarray(rst3), axis=0)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    tb = 5 if T % 8 else 8
    pal_m, pal_a = affine_segscan_pallas(jnp.asarray(mul), jnp.asarray(add),
                                         jnp.asarray(rst), tb=tb,
                                         interpret=True)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(pal_m))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(pal_a))
    if name == "counter":
        got = got_a.numpy()[:, 2, 0]
        assert list(got) == list(range(1, 9)) * 2


def test_affine_segscan_axis_interface_matches_reference():
    """The [L, T, C] / axis-1 interface of ops.assoc, and the wrapper on
    CPU tensors: the plain version, no kernel launch."""
    mul, add, rst = _segscan_case("full_range")
    mul_l = np.ascontiguousarray(np.transpose(mul, (1, 0, 2)))
    add_l = np.ascontiguousarray(np.transpose(add, (1, 0, 2)))
    rst_l = np.ascontiguousarray(rst.T)
    before = AC.affine_segscan.launches
    got_m, got_a = A.affine_segscan(torch.from_numpy(mul_l),
                                    torch.from_numpy(add_l),
                                    torch.from_numpy(rst_l), axis=1)
    assert AC.affine_segscan.launches == before
    want_m, want_a = JA.affine_segscan(
        jnp.asarray(mul_l), jnp.asarray(add_l),
        jnp.asarray(np.broadcast_to(rst_l[:, :, None], mul_l.shape)), axis=1)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_affine_segscan_wrapper_checks():
    m = torch.zeros((4, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="rst"):
        AC.affine_segscan(m, m, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        AC.affine_segscan(m.long(), m.long(),
                          torch.zeros((4, 3), dtype=torch.int32))
    meta = m.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        AC.affine_segscan(meta, meta, torch.zeros((4, 3), device="meta"))


def test_affine_segscan_library_builds_with_nvcc_only():
    """The kernel is registered in ops/_build.py; its library name
    follows its source under build/torch_kernels/."""
    from cadence_tpu_torch.ops import _build

    assert "affine_segscan" in _build.KERNELS
    path = _build._lib_path("affine_segscan")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libaffine_segscan-")


def test_fsm_segscan_matches_reference():
    """The doubling scan of the X_STATE fsm stream == the reference's
    lax.associative_scan over fsm_combine, with segment resets."""
    rng = np.random.default_rng(3)
    L, T = 6, 37
    kind = rng.integers(0, 3, (L, T), dtype=np.int32)
    kval = rng.integers(0, 3, (L, T), dtype=np.int32)
    rst = rng.random((L, T)) < 0.15
    rst[:, 0] = True
    from jax import lax

    wk, wv, _ = lax.associative_scan(
        JA.fsm_combine,
        (jnp.asarray(kind), jnp.asarray(kval), jnp.asarray(rst)), axis=1)
    gk, gv = A.fsm_segscan(torch.from_numpy(kind), torch.from_numpy(kval),
                           torch.from_numpy(rst))
    assert gk.dtype == gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_classifier_and_type_signature_match_reference():
    assert A.assoc_types() == JA.assoc_types()
    assert A.ASSOC_COVERAGE == JA.ASSOC_COVERAGE
    assert A.NOOP_TYPES == JA.NOOP_TYPES
    rng = random.Random(4)
    for _ in range(20):
        present = rng.sample(range(len(E)), rng.randint(0, 12))
        assert type_signature(present) == j_type_signature(present)
        assert A.classify_types(present) == JA.classify_types(present)


# --------------------------------------------------------------------------
# the replay: three-way parity, packed, resumed, hybrid
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_assoc_fm_three_way_parity(impl):
    """port assoc == reference assoc (same impl) == port sequential
    replay, on fuzzed unpacked batches (the reference's
    test_fuzz_assoc_three_way_parity shape)."""
    hs = fuzz(12, seed=1000, target=40)
    pk = P.pack_histories(hs, caps=CAPS)
    jpk = JP.pack_histories(hs, caps=jcaps(CAPS))
    np.testing.assert_array_equal(pk.events, jpk.events)
    types = type_signature(pk.events[:, :, S.EV_TYPE][
        pk.events[:, :, S.EV_TYPE] >= 0])
    want = scan(pk)
    got = A.replay_assoc_fm(S.empty_state(pk.batch, CAPS),
                            A.events_fm_of(pk.events), types=types,
                            impl=impl, device="cpu")
    assert_state_equal(got, want)
    ref = JA.replay_assoc_fm(JS.empty_state(jpk.batch, jcaps(CAPS)),
                             JA.events_fm_of(jpk.events), types=types,
                             impl=impl)
    assert_state_equal(got, ref)
    # unspecialized (every mask computed) gives the same state
    assert_state_equal(
        A.replay_assoc_fm(S.empty_state(pk.batch, CAPS),
                          torch.from_numpy(A.events_fm_of(pk.events)),
                          impl=impl, device="cpu"), want)


def _resume_states(prefixes, caps):
    """Resume states from replaying history prefixes with the port's
    sequential replay (checkpoint-shaped rows)."""
    pk = P.pack_histories(prefixes, caps=caps)
    final = scan(pk)
    return [P.ResumeState(pack=pk.side[i].resume,
                          side=pk.side[i].duplicate(),
                          state_row=S.state_row(final, i))
            for i in range(len(prefixes))]


@pytest.mark.parametrize("impl", IMPLS)
def test_assoc_lanes_and_resume_parity(impl):
    """Lane-packed and checkpoint-resumed batches: segment starts reset
    the composition and resumed init rows lead their segments, equal to
    the port's sequential packed replay and to the reference's assoc,
    including a zero-event suffix (checkpoint at the tip)."""
    hs = fuzz(6, seed=2000, target=24, close_every=2)
    lanes = P.pack_lanes(hs, caps=CAPS, target_lane_len=128)
    want = replay_packed_lanes(lanes, scan_mode="scan", device="cpu")
    got = A.replay_assoc_lanes(lanes, impl=impl, device="cpu")
    assert_state_equal(got, want)
    jlanes = JP.pack_lanes(hs, caps=jcaps(CAPS), target_lane_len=128)
    assert_state_equal(got, JA.replay_assoc_lanes(jlanes, impl=impl))

    cuts = [len(b) if i == len(hs) - 1 else max(1, len(b) * (1 + i % 3) // 4)
            for i, (_, _, b) in enumerate(hs)]
    prefixes = [(w, r, b[:c]) for (w, r, b), c in zip(hs, cuts)]
    suffixes = [(w, r, b[c:]) for (w, r, b), c in zip(hs, cuts)]
    resume = _resume_states(prefixes, CAPS)
    lanes_r = P.pack_lanes(suffixes, caps=CAPS, target_lane_len=128,
                           resume=resume)
    assert lanes_r.initial is not None
    want_r = replay_packed_lanes(lanes_r, scan_mode="scan", device="cpu")
    got_r = A.replay_assoc_lanes(lanes_r, impl=impl, device="cpu")
    assert_state_equal(got_r, want_r)
    # ...and each resumed snapshot equals the whole history's
    pk_whole = P.pack_histories(hs, caps=CAPS)
    whole = scan(pk_whole)
    for i in range(len(hs)):
        assert (state_row_to_snapshot(got_r, i, lanes_r.epoch_s)
                == state_row_to_snapshot(whole, i, pk_whole.epoch_s))
    # unpacked resumed batch: init rows through replay_assoc_fm
    pk_r = P.pack_histories(suffixes, caps=CAPS, resume=resume)
    got_u = A.replay_assoc_fm(pk_r.initial, A.events_fm_of(pk_r.events),
                              impl=impl, device="cpu")
    assert_state_equal(got_u, scan(pk_r))


@pytest.mark.parametrize("impl", IMPLS)
def test_assoc_hybrid_nonaffine_fallback(impl):
    """The hybrid seam: with timer transitions declared nonaffine,
    replay_assoc splits the time axis at those steps (single sequential
    FSM steps between associative chunks) and still equals the
    sequential replay and the reference's hybrid."""
    hs = fuzz(4, seed=3000, target=48, close_every=2)
    pk = P.pack_histories(hs, caps=CAPS)
    restricted = A.assoc_types() - {
        int(E.TimerStarted), int(E.TimerFired), int(E.TimerCanceled)}
    present = {int(t) for t in pk.events[:, :, S.EV_TYPE].ravel() if t >= 0}
    _, non = A.classify_types(present, frozenset(restricted))
    assert non, "fuzz batch has no timer events; raise target_events"
    got = A.replay_assoc(S.empty_state(pk.batch, CAPS), pk.time_major(),
                         affine_types=frozenset(restricted), impl=impl,
                         device="cpu")
    assert_state_equal(got, scan(pk))
    jpk = JP.pack_histories(hs, caps=jcaps(CAPS))
    ref = JA.replay_assoc(JS.empty_state(jpk.batch, jcaps(CAPS)),
                          jpk.time_major(),
                          affine_types=frozenset(restricted), impl=impl)
    assert_state_equal(got, ref)


# --------------------------------------------------------------------------
# the one cross-column read: X_DECISION_TIMEOUT_VALUE into the
# increment's X_DEC_TIMEOUT
# --------------------------------------------------------------------------

_SEC = 1_000_000_000
_T0 = 1_700_000_000 * _SEC


def _dtv_history(k: int):
    """A start with decision timeout 10 + k, a decision that fails (the
    attempt-incrementing branch, whose X_DEC_TIMEOUT reads the start's
    value), then signals. Returns (batches, cut) with the cut after the
    decision started, so a resumed suffix begins at the failure."""
    v = 10
    b = [[F.workflow_execution_started(
        1, v, _T0, task_start_to_close_timeout_seconds=10 + k)]]
    b.append([F.decision_task_scheduled(2, v, _T0,
                                        start_to_close_timeout_seconds=5)])
    b.append([F.decision_task_started(3, v, _T0 + _SEC,
                                      scheduled_event_id=2)])
    b.append([F.decision_task_failed(4, v, _T0 + 2 * _SEC,
                                     scheduled_event_id=2,
                                     started_event_id=3)])
    for j in range(k % 3):
        b.append([F.workflow_execution_signaled(5 + j, v,
                                                _T0 + (3 + j) * _SEC)])
    return b, 3


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", ["unpacked", "lanes"])
@pytest.mark.parametrize("resumed", [False, True], ids=["whole", "resumed"])
def test_decision_timeout_cross_column_read(impl, layout, resumed):
    """The increment's X_DEC_TIMEOUT is the X_DECISION_TIMEOUT_VALUE
    written before it: by the start inside the same segment, or by the
    resumed init row; never by another history's start in the lane."""
    n = 6
    hs, resume = [], None
    full = [_dtv_history(k) for k in range(n)]
    if resumed:
        prefixes = [(f"wf-{k}", f"run-{k}", b[:c])
                    for k, (b, c) in enumerate(full)]
        resume = _resume_states(prefixes, CAPS)
        hs = [(f"wf-{k}", f"run-{k}", b[c:]) for k, (b, c) in enumerate(full)]
    else:
        hs = [(f"wf-{k}", f"run-{k}", b) for k, (b, _) in enumerate(full)]
    if layout == "lanes":
        pk = P.pack_lanes(hs, caps=CAPS, target_lane_len=32, resume=resume)
        assert max(len(s) for s in pk.lane_segments) > 1
        want = replay_packed_lanes(pk, scan_mode="scan", device="cpu")
        got = A.replay_assoc_lanes(pk, impl=impl, device="cpu")
    else:
        pk = P.pack_histories(hs, caps=CAPS, resume=resume)
        init = pk.initial if resumed else S.empty_state(pk.batch, CAPS)
        want = scan(pk)
        got = A.replay_assoc_fm(init, A.events_fm_of(pk.events), impl=impl,
                                device="cpu")
    got = S.state_to_numpy(got)
    assert_state_equal(got, want)
    dec_timeout = got.exec_info[:n, S.X_DEC_TIMEOUT]
    assert list(dec_timeout) == [10 + k for k in range(n)]
    assert (got.exec_info[:n, S.X_DEC_ATTEMPT] == 1).all()


# --------------------------------------------------------------------------
# the facades and the dispatcher under scan_mode="assoc"
# --------------------------------------------------------------------------


def _retry(n, depth, seed=5, prefix=""):
    rng = random.Random(seed)
    return [(f"wf-{prefix}{i}", f"run-{prefix}{i}",
             W.retry_deep_history(rng, depth=depth)) for i in range(n)]


@pytest.mark.parametrize("packing", ["histories", "lanes"])
def test_replay_packed_assoc_matches_scan(packing):
    """replay_packed(scan_mode="assoc") == "scan", on a batch off the
    round_scan_len grid (10 histories pad to 12) and on lanes; and
    against the reference facade's assoc route."""
    hs = _retry(10, 150)
    if packing == "lanes":
        pk = P.pack_lanes(hs, caps=RETRY_CAPS, target_lane_len=256,
                          seg_align=16)
        jpk = JP.pack_lanes(_jretry(10, 150), caps=jcaps(RETRY_CAPS),
                            target_lane_len=256, seg_align=16)
    else:
        pk = P.pack_histories(hs, caps=RETRY_CAPS)
        jpk = JP.pack_histories(_jretry(10, 150), caps=jcaps(RETRY_CAPS))
    got = replay_packed(pk, scan_mode="assoc", device="cpu")
    assert got.exec_info.shape[0] == 10
    assert_state_equal(got, replay_packed(pk, scan_mode="scan",
                                          device="cpu"))
    assert_state_equal(got, j_replay_packed(jpk, scan_mode="assoc"))


def _jretry(n, depth, seed=5):
    rng = random.Random(seed)
    return [(f"wf-{i}", f"run-{i}", JW.retry_deep_history(rng, depth=depth))
            for i in range(n)]


def _snapshots(results, n, bucketed):
    out = [None] * n
    base = 0
    for entry in results:
        if bucketed:
            idxs, packed, final = entry
        else:
            packed, final = entry
            idxs = range(base, base + final.exec_info.shape[0])
            base += final.exec_info.shape[0]
        final = S.state_to_numpy(final)
        for j, i in enumerate(idxs):
            out[i] = state_row_to_snapshot(final, j, packed.epoch_s)
    return out


@pytest.mark.parametrize("bucket", [True, False],
                         ids=["lanes_assoc", "hist_assoc"])
def test_replay_stream_assoc_matches_scan(bucket, monkeypatch):
    """The dispatcher's assoc modes (bucketed lane packing and unpacked
    batches padded to the grid) give the sequential route's snapshots;
    a resumed history rides them too."""
    calls = []
    core = D._assoc_core
    monkeypatch.setattr(
        D, "_assoc_core", lambda *a, **k: calls.append(1) or core(*a, **k))
    rng = random.Random(43)
    hs = [(f"wf-s{i}", f"run-s{i}", W.retry_deep_history(rng, depth=16))
          for i in range(9)]
    hs += [(f"wf-d{i}", f"run-d{i}", W.retry_deep_history(rng, depth=200))
           for i in range(2)]
    cut = len(hs[3][2]) // 2
    resume = [None] * len(hs)
    resume[3] = _resume_states([(hs[3][0], hs[3][1], hs[3][2][:cut])],
                               RETRY_CAPS)[0]
    hs_r = list(hs)
    hs_r[3] = (hs[3][0], hs[3][1], hs[3][2][cut:])
    kw = dict(caps=RETRY_CAPS, batch_size=5, bucket=bucket, device="cpu")
    got = D.replay_stream(hs_r, resume=resume, scan_mode="assoc", **kw)
    assert len(calls) == len(got)
    want = D.replay_stream(hs, scan_mode="scan", **kw)
    assert len(calls) == len(got)
    assert (_snapshots(got, len(hs), bucket)
            == _snapshots(want, len(hs), bucket))
    with D.DeviceDispatcher(RETRY_CAPS, scan_mode="assoc",
                            lane_pack=bucket, device="cpu") as d:
        d.submit(0, hs[:5])
        d.finish()
        (_, _, final), = list(d.results())
    assert final.exec_info.shape[0] == 5
    assert final.exec_info.dtype == torch.int32


@pytest.mark.parametrize("lane_pack", [True, False],
                         ids=["lanes_assoc", "hist_assoc"])
def test_dispatcher_assoc_types_are_per_batch(lane_pack, monkeypatch):
    """Each assoc batch is specialized on its own type signature, not on
    the types of batches before it, and still gives the sequential
    route's state."""
    seen = []
    core = D._assoc_core
    monkeypatch.setattr(D, "_assoc_core", lambda *a, **k: seen.append(
        k["types"]) or core(*a, **k))
    rng = random.Random(7)
    batches = [[(f"wf-t{i}", f"run-t{i}",
                 W.timer_storm_history(rng, depth=60, fanout=3))
                for i in range(3)],
               [(f"wf-e{i}", f"run-e{i}", W.echo_history())
                for i in range(3)]]
    with D.DeviceDispatcher(CAPS, scan_mode="assoc", lane_pack=lane_pack,
                            device="cpu") as d:
        for i, hs in enumerate(batches):
            d.submit(i, hs)
        d.finish()
        results = list(d.results())
    want_types = []
    for (_, packed, final), hs in zip(results, batches):
        present = (packed.present_types if lane_pack else
                   [t for t in np.unique(packed.events[:, :, S.EV_TYPE])
                    if t >= 0])
        want_types.append(type_signature(present))
        assert_state_equal(final, replay_packed(
            P.pack_histories(hs, caps=CAPS), scan_mode="scan",
            device="cpu"))
    assert seen == want_types
    assert seen[0] != seen[1]
