"""The port's process-group replay fabric (``cadence_tpu_torch.parallel``
and ``cadence_tpu_torch.entry``) against the reference package's mesh
code, on the CPU.

The reference side runs in this process on conftest's 8-device virtual
CPU mesh; the port's side runs on 8 gloo ranks from ``run_ranks``, one
spawn for every multi-rank case (``testing/parallel_workers.py``). Both
take ``tests/test_parallel.py``'s fixture: 16 fuzzed histories of 30
events (seed 11), ``max_events=64``. Every int32 result must agree
exactly, dtypes included."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu import parallel as JPAR
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.replay import replay_packed as j_replay_packed
from cadence_tpu.parallel.mesh import shard_spec as j_shard_spec
from cadence_tpu.testing.event_generator import HistoryFuzzer as JFuzzer

import __graft_entry__

from cadence_tpu_torch import entry as ENTRY
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.refresh import FIELDS
from cadence_tpu_torch.parallel.launch import run_ranks
from cadence_tpu_torch.parallel.mesh import mesh_grid
from cadence_tpu_torch.testing import parallel_workers as PW
from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

CAPS = dict(max_events=64)
WORLD = 8
SPAWN_TIMEOUT_S = 600


def histories(fuzzer_cls):
    fuzzer = fuzzer_cls(seed=11, caps=caps_of(fuzzer_cls))
    return [(f"wf-{i}", f"run-{i}", fuzzer.generate(target_events=30))
            for i in range(16)]


def caps_of(fuzzer_cls):
    return (S if fuzzer_cls is HistoryFuzzer else JS).Capacities(**CAPS)


@pytest.fixture(scope="module")
def packed():
    """(the port's pack, the reference's pack) of the same histories."""
    pk = P.pack_histories(histories(HistoryFuzzer), caps=caps_of(
        HistoryFuzzer), pad_batch_to=16)
    jpk = JP.pack_histories(histories(JFuzzer), caps=caps_of(JFuzzer),
                            pad_batch_to=16)
    np.testing.assert_array_equal(pk.events, jpk.events)
    return pk, jpk


@pytest.fixture(scope="module")
def ranks(packed):
    """Each rank's results of ``differential_cases``."""
    return run_ranks(PW.differential_cases, WORLD, backend="gloo",
                     device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                     args=(packed[0],))


@pytest.fixture(scope="module")
def single_device(packed):
    return j_replay_packed(packed[1])


def j_mesh(seq):
    return JPAR.make_mesh(jax.devices()[:WORLD], seq=seq)


def assert_fields_equal(got: dict, want, names):
    for f in names:
        w = np.asarray(getattr(want, f))
        assert got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)


@pytest.mark.parametrize("seq", [1, 2, 4, 8])
def test_mesh_grid_matches_reference(seq):
    want = np.vectorize(lambda d: d.id)(j_mesh(seq).devices)
    np.testing.assert_array_equal(mesh_grid(WORLD, seq), want)


def test_mesh_rejects_a_world_not_divisible_by_seq():
    with pytest.raises(ValueError, match="not divisible by seq=3"):
        mesh_grid(WORLD, 3)
    with pytest.raises(ValueError):
        JPAR.make_mesh(jax.devices()[:WORLD], seq=3)


@pytest.mark.parametrize("seq", [1, 2, 4, 8])
def test_make_mesh_coordinates_in_ranks(ranks, seq):
    grid = mesh_grid(WORLD, seq)
    for r, res in enumerate(ranks):
        c = res["meshes"][seq]
        assert c["shape"] == {"shard": WORLD // seq, "seq": seq}
        assert (c["shard_index"], c["seq_index"]) == divmod(r, seq)
        assert c["shard_ranks"] == tuple(grid[:, r % seq])
        assert c["seq_ranks"] == tuple(grid[r // seq])


@pytest.mark.parametrize("mode", ["scan", "assoc"])
@pytest.mark.parametrize("seq", [1, 2])
def test_sharded_matches_reference(packed, ranks, single_device, seq, mode):
    j_final, j_tasks = JPAR.replay_packed_sharded(packed[1], j_mesh(seq),
                                                  scan_mode=mode)
    for res in ranks:
        final, tasks = res["sharded"][seq, mode]
        assert_fields_equal(final, j_final, S.STATE_ROW_FIELDS)
        assert_fields_equal(final, single_device, S.STATE_ROW_FIELDS)
        assert_fields_equal(tasks, j_tasks, FIELDS)
        # the port's two modes agree with each other too
        scan_final, scan_tasks = res["sharded"][seq, "scan"]
        for f in S.STATE_ROW_FIELDS:
            np.testing.assert_array_equal(final[f], scan_final[f])
        for f in FIELDS:
            np.testing.assert_array_equal(tasks[f], scan_tasks[f])


@pytest.mark.parametrize("seq,n_micro", [(2, 2), (4, 2), (8, 1)])
def test_pipelined_matches_reference(packed, ranks, single_device, seq,
                                     n_micro):
    init = jax.tree_util.tree_map(
        jnp.asarray, JS.empty_state(packed[1].batch, JS.Capacities(**CAPS)))
    want = JPAR.replay_pipelined(init, jnp.asarray(packed[1].time_major()),
                                 j_mesh(seq), n_micro=n_micro)
    grid = mesh_grid(WORLD, seq)
    for f in S.STATE_ROW_FIELDS:
        # every rank of a shard holds its block, whatever its stage
        for j in range(seq):
            got = np.concatenate([ranks[r]["pipelined"][seq, n_micro][f]
                                  for r in grid[:, j]])
            np.testing.assert_array_equal(got, np.asarray(getattr(want, f)),
                                          err_msg=f)
            np.testing.assert_array_equal(
                got, getattr(single_device, f), err_msg=f)


@pytest.mark.parametrize("seq", [1, 2])
def test_ndc_snapshot_exchange_matches_reference(ranks, single_device, seq):
    mesh = j_mesh(seq)
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), j_shard_spec(mesh)),
        single_device)
    want = [np.asarray(x) for x in JPAR.ndc_snapshot_exchange(state, mesh)]
    assert want[3].dtype == np.int32 and int(want[3]) == 16
    for res in ranks:
        got = res["exchange"][seq]
        assert len(got) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case,match", [
    ("auto", "scan_mode must be one of scan/assoc"),
    ("batch", "batch 12 not divisible by shard axis 8"),
    ("steps", "steps 63 not divisible by 2"),
    ("n_micro", "local batch 4 not divisible by n_micro=3"),
])
def test_errors_before_any_collective(ranks, case, match):
    for res in ranks:
        assert match in res["errors"][case]


def test_a_rank_that_raises_fails_the_call_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        run_ranks(PW.raise_on, 2, backend="gloo", device="cpu",
                  timeout_s=SPAWN_TIMEOUT_S, args=(1,))
    msg = str(info.value)
    assert "rank 1 of 2 failed" in msg
    assert "ValueError: rank 1 refuses" in msg and "Traceback" in msg
    # the error ended the call, not the deadline
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 2


def test_a_hung_rank_is_killed_at_the_deadline():
    t0 = time.monotonic()
    # rank 1 sleeps past the deadline; on a loaded host rank 0 may still
    # be starting when it passes, so the message may name it too
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[(0, )?1\] of 2"):
        run_ranks(PW.sleep_on, 2, backend="gloo", device="cpu",
                  timeout_s=5, args=(1, 600.0))
    # the deadline, plus the kill and join
    assert time.monotonic() - t0 < 60


def test_backends_need_their_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="nccl"):
        run_ranks(PW.sleep_on, 2, backend="nccl", device="cpu",
                  timeout_s=5, args=(0, 0.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(PW.sleep_on, 2, backend="gloo", device="cuda",
                  timeout_s=5, args=(0, 0.0))
    with pytest.raises(ValueError, match="backend"):
        run_ranks(PW.sleep_on, 2, backend="mpi", device="cpu",
                  timeout_s=5, args=(0, 0.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY.entry()


def test_entry_forward_matches_graft_entry():
    j_fn, j_args = __graft_entry__.entry()
    j_final, j_tasks = jax.jit(j_fn)(*j_args)
    fn, args = ENTRY.entry(device="cpu")
    final, tasks = fn(*args)
    got = S.state_to_numpy(final)
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(j_final, f)))
    for f in FIELDS:
        g, w = getattr(tasks, f).numpy(), np.asarray(getattr(j_tasks, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_dryrun_multichip_completes():
    recs = ENTRY.dryrun_multichip(4, device="cpu", backend="gloo",
                                  timeout_s=SPAWN_TIMEOUT_S)
    assert [r["rank"] for r in recs] == [0, 1, 2, 3]
    for r in recs:
        assert r["mesh"] == {"shard": 2, "seq": 2}
        assert r["pipelined"] and r["replayed"] == r["batch"] == 8
