"""``correct`` fails where it should: the control (the reference in the
program's place, in bfloat16) and the faults a cell can have fail the
cell's limits, and a run whose timed path is broken underneath comes out
not correct.  At a size the CPU holds; the readings at each cell's own
size come from ``python3 -m portbench.control`` on the card
(``PERF.md``)."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import CELLS, tiny

TRAIN = [c for c in CELLS if c != "ldpc_decode.b4096"]


def fails(nums: dict, limits: dict) -> bool:
    """Some compared number is over its limit."""
    return any(not (nums[k] <= v) for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_limits(name):
    # decode: enough words that bfloat16 flips some decisions
    cell = tiny(name, 256 if name == "ldpc_decode.b4096" else 8)
    got = control.readings(cell, 11, device="cpu", n_workers=1)
    for what in ("control", "half_batch", "answer_altered"):
        if what in got:
            assert fails(got[what], cell.limits), (what, got[what])


def _run(name, hooks, program_batch=None):
    cell = tiny(name)
    return harness.execute(cell, 2 ** 31 + 5, 0.2, 0, device="cpu",
                           n_workers=1, hooks=hooks,
                           program_batch=program_batch)


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name):
    def hook(prog):
        step = prog.step

        def unchanged(staged):
            keep = {k: v.detach().clone()
                    for k, v in prog.model.state_dict().items()}
            out = step(staged)
            prog.model.load_state_dict(keep)
            return out

        prog.step = unchanged

    out = _run(name, hook)
    assert not out["correct"]
    assert out["check"]["change_gap_median"]["value"] >= 0.99


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name):
    def hook(prog):
        stage = prog.stage

        def half(batch):
            n = batch["node_feature"].shape[0] // 2
            return stage({k: v[:n] for k, v in batch.items()})

        prog.stage = half

    out = _run(name, hook, program_batch=4)
    assert not out["correct"], out["check"]


def test_decode_half_of_the_batch_left_out():
    def hook(prog):
        decode = prog.decode

        def half(batch):
            n = batch["node_feature"].shape[0] // 2
            d = decode({k: v[:n] for k, v in batch.items()})
            return torch.cat([d, torch.zeros_like(d)])

        prog.decode = half

    assert not _run("ldpc_decode.b4096", hook)["correct"]


def test_decode_answer_altered():
    def hook(prog):
        decode = prog.decode

        def altered(batch):
            d = decode(batch).clone()
            d[0] = 1 - d[0]
            return d

        prog.decode = altered

    assert not _run("ldpc_decode.b4096", hook)["correct"]
