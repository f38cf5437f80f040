"""The check fails what it must: the control (the port's step on a lossy
int16 event stream) and each planted fault come out not correct, while
the port's own step comes out correct. At a tiny size on the CPU, and
at a reduced size on the card."""

import pytest

import control

from conftest import TINY, tiny

FAULTS = [m for m in control.MODES if m != "program"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_and_faults_fail_and_the_program_passes(cell):
    depth, max_events = TINY[cell]
    c = tiny(cell, depth=depth, max_events=max_events)
    got = {mode: (ok, checks) for mode, ok, checks, _ in control.readings(
        c, 2**31 + 3, 0.05, control.MODES, "cpu")}
    ok, checks = got["program"]
    assert ok, checks
    for mode in FAULTS:
        ok, checks = got[mode]
        assert not ok, (mode, checks)
        assert max(v["value"] for v in checks.values()) > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_and_faults_fail_on_the_card(card, cell):
    """Full depth and widths, 2,048 lanes of 32 uniques."""
    c = tiny(cell, uniques=32, lanes=2048, depth=1000, max_events=1024)
    got = {mode: ok for mode, ok, _, _ in control.readings(
        c, 2**31 + 3, 0.5, control.MODES, "cuda")}
    assert got.pop("program") is True
    assert not any(got.values()), got
