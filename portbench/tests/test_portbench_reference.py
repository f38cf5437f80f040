"""The reference in ``yardstick/`` against the port's plain route (the
CPU path of ``replay_scan_teb`` and of ``refresh_tasks_device``) on
histories of each configuration at a tiny size."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import port
import run
from yardstick import histories as H
from yardstick import reference as REF
from yardstick import schema as YS

from conftest import tiny


def _port_plain(prog, hs, caps_dict):
    S = prog.S
    caps = S.Capacities(**caps_dict)
    packed = prog.P.pack_histories(port.to_port(prog, hs), caps=caps)
    state0 = S.state_from_numpy(S.empty_state(len(hs), caps), "cpu")
    final = prog.RC.replay_scan_teb(
        state0, torch.from_numpy(np.array(packed.teb())), caps)
    tasks = prog.R.refresh_tasks_device(final)
    return ({f: getattr(final, f).numpy() for f in S.STATE_ROW_FIELDS},
            {f: getattr(tasks, f).numpy() for f in prog.R.FIELDS})


@pytest.mark.parametrize("config,seed", [
    ("retry_deep", 3), ("retry_deep", 2**31 + 11), ("ndc_storm", 5),
    ("ndc_storm", 2**31 + 13)])
def test_reference_equals_the_port_plain_route(config, seed):
    cell = tiny(f"{config}.storm_resident", uniques=6)
    hs = H.make(cell.config, seed)
    prog = port.program("cpu")
    got_state, got_tasks = _port_plain(prog, hs, cell.config["caps"])
    ref_state, ref_tasks = REF.replay_histories(hs, H.caps_of(cell.config))
    for f in YS.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(got_state[f], getattr(ref_state, f),
                                      err_msg=f)
    assert set(got_tasks) == set(ref_tasks)
    for f, want in ref_tasks.items():
        assert got_tasks[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got_tasks[f], want, err_msg=f)
    # the histories move the state: not every lane is still empty
    assert (ref_state.exec_info[:, YS.X_NEXT_EVENT_ID] > 20).all()


def test_reference_blocks_agree():
    cell = tiny("ndc_storm.storm_resident", uniques=5)
    hs = H.make(cell.config, 17)
    caps = H.caps_of(cell.config)
    whole = REF.replay_histories(hs, caps)
    blocks = REF.replay_histories(hs, caps, block=2)
    for f in YS.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(whole[0], f),
                                      getattr(blocks[0], f))
    for f in whole[1]:
        np.testing.assert_array_equal(whole[1][f], blocks[1][f])


def test_resumed_tail_equals_a_whole_replay():
    """The cell's checkpoint route (prefix replayed, tail packed from the
    checkpoint) against the reference's replay of each whole history."""
    name = "retry_deep.resume_tail"
    cell = tiny(name, uniques=4, lanes=8, depth=110, max_events=128)
    ctx = run.prepare(cell, 21, "cpu")
    assert ctx.inp.steps == 16
    assert all(0 < n <= 16 for n in ctx.inp.tail_events)
    out = ctx.driver.step(ctx.prog, ctx.inp, run.spans_of(False))()
    checks, failed = run.check(run.outputs_to_host(ctx, [out]),
                               run.reference(ctx), ctx.lanes)
    assert failed == 0 and checks["state_lanes_wrong"]["value"] == 0


@pytest.mark.parametrize("frac", [0.125, 0.5])
def test_split_tail_keeps_whole_batches_within_the_fraction(frac):
    cell = tiny("retry_deep.storm_resident", uniques=3, depth=200,
                max_events=256)
    for h in H.make(cell.config, 9):
        pre, tail = H.split_tail(h, frac)
        assert pre and tail and pre + tail == h
        assert H.n_events(tail) <= int(H.n_events(h) * frac)


def test_generators_follow_the_seed():
    for config in ("retry_deep", "ndc_storm"):
        cell = tiny(f"{config}.storm_resident", uniques=3)
        a = H.make(cell.config, 2**31 + 5)
        b = H.make(cell.config, 2**31 + 5)
        c = H.make(cell.config, 2**31 + 6)
        dump = lambda hs: [[[dataclasses.astuple(e) for e in bt] for bt in h]
                           for h in hs]
        assert dump(a) == dump(b)
        assert dump(a) != dump(c)
