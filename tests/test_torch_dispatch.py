"""The port's pipelined dispatcher against the reference package's:
``replay_stream`` snapshots (bucketed lane packing, unpacked batches,
checkpoint resume) and the ``results(strict=)`` drain semantics."""

import random

import numpy as np
import pytest

from cadence_tpu.ops import dispatch as JD
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops import unpack as JU
from cadence_tpu.testing import workloads as JW

from cadence_tpu_torch.ops import dispatch as D
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.ops.unpack import state_row_to_snapshot
from cadence_tpu_torch.testing import workloads as W

CAPS = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                    max_children=2, max_request_cancels=2,
                    max_signals_ext=2, max_version_items=2)


def jcaps(caps):
    return JS.Capacities(**{f: getattr(caps, f)
                            for f in caps.__dataclass_fields__})


def mixed_depth(gen_mod, n_shallow=27, n_deep=3, seed=43):
    """The mixed_depth shape: 90% shallow retry histories, 10% deep."""
    rng = random.Random(seed)
    hs = [(f"wf-s{i}", f"run-s{i}", gen_mod.retry_deep_history(rng, depth=16))
          for i in range(n_shallow)]
    hs += [(f"wf-d{i}", f"run-d{i}",
            gen_mod.retry_deep_history(rng, depth=200))
           for i in range(n_deep)]
    order = random.Random(seed + 1).sample(range(len(hs)), len(hs))
    return [hs[i] for i in order]


def port_snapshots(results, n, bucketed):
    out = [None] * n
    base = 0
    for entry in results:
        if bucketed:
            idxs, packed, final = entry
        else:
            packed, final = entry
            rows = final.exec_info.shape[0]
            idxs = range(base, base + rows)
            base += rows
        for j, i in enumerate(idxs):
            out[i] = state_row_to_snapshot(final, j, packed.epoch_s)
    return out


def ref_snapshots(results, n, bucketed):
    out = [None] * n
    base = 0
    for entry in results:
        if bucketed:
            idxs, packed, final = entry
        else:
            packed, final = entry
            rows = final.exec_info.shape[0]
            idxs = range(base, base + rows)
            base += rows
        final = JS.StateTensors(*(np.asarray(getattr(final, f))
                                  for f in S.STATE_ROW_FIELDS))
        for j, i in enumerate(idxs):
            out[i] = JU.state_row_to_snapshot(final, j, packed.epoch_s)
    return out


@pytest.mark.parametrize("narrow", [True, False], ids=["int16", "int32"])
def test_replay_stream_bucketed_matches_reference(narrow):
    """bucket=True: depth buckets, lane packing and the kernel's packed
    route; every snapshot equals the reference dispatcher's."""
    hs = mixed_depth(W)
    jhs = mixed_depth(JW)
    got = D.replay_stream(hs, caps=CAPS, batch_size=16, bucket=True,
                          narrow=narrow, device="cpu")
    want = JD.replay_stream(jhs, caps=jcaps(CAPS), batch_size=16,
                            bucket=True, scan_mode="scan")
    assert len(got) == len(want) >= 3
    assert port_snapshots(got, len(hs), True) == ref_snapshots(
        want, len(hs), True)


@pytest.mark.parametrize("lane_pack", [False, True])
def test_replay_stream_batches_match_reference(lane_pack):
    hs = mixed_depth(W, n_shallow=9, n_deep=2, seed=5)
    jhs = mixed_depth(JW, n_shallow=9, n_deep=2, seed=5)
    got = D.replay_stream(hs, caps=CAPS, batch_size=4, lane_pack=lane_pack,
                          device="cpu")
    want = JD.replay_stream(jhs, caps=jcaps(CAPS), batch_size=4,
                            lane_pack=lane_pack, scan_mode="scan")
    assert port_snapshots(got, len(hs), False) == ref_snapshots(
        want, len(hs), False)


def test_replay_stream_resume_matches_full_replay():
    """Resumed histories (snapshot row + event suffix) replay through the
    dispatcher's lane route to the full history's state."""
    full = mixed_depth(W, n_shallow=6, n_deep=2, seed=7)
    cut = [len(b) // 2 for _, _, b in full]
    prefixes = [(w, r, b[:c]) for (w, r, b), c in zip(full, cut)]
    pk = P.pack_histories(prefixes, caps=CAPS)
    final = replay_packed(pk, device="cpu")
    resume = [P.ResumeState(pack=pk.side[i].resume,
                            side=pk.side[i].duplicate(),
                            state_row=S.state_row(final, i))
              for i in range(len(full))]
    resume[0] = None        # one history replays whole
    hs = [(w, r, b if res is None else b[c:])
          for (w, r, b), c, res in zip(full, cut, resume)]
    got = D.replay_stream(hs, caps=CAPS, bucket=True, resume=resume,
                          device="cpu")
    whole = D.replay_stream(full, caps=CAPS, bucket=True, device="cpu")
    assert port_snapshots(got, len(full), True) == port_snapshots(
        whole, len(full), True)


def test_depth_buckets_match_reference():
    hs = mixed_depth(W)
    got = [idxs for idxs, _ in D.depth_buckets(hs)]
    want = [idxs for idxs, _ in JD.depth_buckets(mixed_depth(JW))]
    assert got == want and len(got) >= 2


def test_dispatcher_strict_and_lenient_failures():
    """A batch that fails to pack raises its DispatchError in order
    (strict) or is yielded (strict=False) while later batches still run."""
    good = mixed_depth(W, n_shallow=3, n_deep=0, seed=3)
    bad = [("wf-bad", "run-bad", [[]])]
    with D.DeviceDispatcher(CAPS, device="cpu") as d:
        d.submit(0, good)
        d.submit(1, bad)
        d.submit(2, good)
        d.finish()
        out = list(d.results(strict=False))
    assert [type(o).__name__ for o in out] == [
        "tuple", "DispatchError", "tuple"]
    assert out[1].batch_id == 1

    with D.DeviceDispatcher(CAPS, device="cpu") as d:
        d.submit(0, bad)
        d.submit(1, good)
        d.finish()
        with pytest.raises(D.DispatchError):
            list(d.results())


def test_dispatcher_rejects_unknown_scan_mode():
    with pytest.raises(ValueError, match="scan_mode"):
        D.DeviceDispatcher(CAPS, scan_mode="fast", device="cpu")
