"""A run with the timed path broken underneath comes out not correct; a
sound run and the float8 control bracket the limit. On the CPU, at a tiny
size, through the whole harness but its look for a card: set-up, window,
the check against the cell's own limits."""
import pytest

from rmem_ocu_tpu_torch import InferEngine
from rmembench import check
from rmembench.testutil import run_cpu, tiny_cell

ORIG = {k: getattr(InferEngine, k)
        for k in ('propagate', 'predict_mask', 'update_memory')}


def state_unchanged(self, state, mask):
    """update_memory returns the state as it came: nothing written."""
    return state


def half_the_batch(self, state, img, mask=None):
    """The second half of the streams left out, given the mean of the
    first half's logits."""
    logits, state = ORIG['propagate'](self, state, img, mask)
    b = logits.shape[0] // 2
    logits = logits.clone()
    logits[b:] = logits[:b].mean(0, keepdim=True)
    return logits, state


def answer_altered(self, logits, size):
    """One pixel of every mask moved to the next label where it is
    produced."""
    pred = ORIG['predict_mask'](self, logits, size).clone()
    y, x = size[0] // 2, size[1] // 2
    pred[:, y, x] = (pred[:, y, x] + 1) % 4
    return pred


FAULTS = {'state_unchanged': ('update_memory', state_unchanged),
          'half_the_batch': ('propagate', half_the_batch),
          'answer_altered': ('predict_mask', answer_altered)}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    name, fn = FAULTS[fault]
    monkeypatch.setattr(InferEngine, name, fn)
    res = run_cpu(tiny_cell())
    assert res['correct'] is False, res['checks']


def test_sound_run_is_correct_and_the_control_is_not():
    cell = tiny_cell()
    res = run_cpu(cell, control=True)
    assert res['correct'] is True, res['checks']
    assert check.control_verdict(res['control_readings'],
                                 cell['limits']) is False
    assert list(res['checks']) == ['mask_gap', 'bank_mismatch']
