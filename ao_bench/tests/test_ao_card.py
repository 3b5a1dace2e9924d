"""On the card, at the rehearsal's size: the program through kernel B1
passes the comparison, and the control -- the reference computed in
TF32 in the program's place -- fails it.  Skips without a card."""

import time

import pytest
import torch

from ao_bench import harness


def run_on(card, workload, control=None):
    cell = harness.Cell(workload)
    cell.rehearse()
    torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
    try:
        return harness.run(cell, 2 ** 31 + 5, 0.5, False, card,
                           time.perf_counter(), control=control,
                           log=lambda _: None)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ref512.shared", "strong512.shared",
                                      "ref512.decorrelated"])
def test_program_passes_and_control_fails_on_the_card(card, workload):
    prog = run_on(card, workload)
    assert prog["correct"] is True, prog["checks"]
    assert prog["device"]["platform"] == "gpu"
    ctl = run_on(card, workload, control="tf32")
    assert ctl["correct"] is False, ctl["checks"]
