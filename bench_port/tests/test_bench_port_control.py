"""The comparison fails what it must: the reference in the program's place
at the precision below the configuration's (float8) fails the cell's
limits, and a run whose timed path is broken underneath comes out not
correct, for each fault a training cell can have: a step that leaves the
state unchanged, half of each batch left out with the mean over the rest,
and an answer (the train CER) altered where it is produced."""
import functools
import os

import pytest
import torch

import harness


@pytest.mark.parametrize("cell", ["ctc_train", "mlm_train_t1024"])
def test_lower_precision_fails(cell, shrink):
    r = harness.run(cell, 31, 0.3, False, device="cpu", shrink=shrink,
                    controls=[{"precision": "fp8"}], log=open(os.devnull, "w"))
    assert r["correct"]
    numbers = r["controls"][0]["numbers"]
    assert not harness.verdict(numbers, harness.cell_spec(cell)["limits"]), numbers


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from llm_bci_tpu_torch.models.ndt1 import NDT1

    forward = NDT1.forward

    @functools.wraps(forward)       # the trainer reads the forward's parameters
    def half(self, **batch):
        rows = batch["spikes"].shape[0] // 2
        cut = {k: (v[:rows] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * rows
                   else v) for k, v in batch.items()}
        out = forward(self, **cut)
        out.loss = out.loss * 2.0
        with torch.no_grad():       # whole-batch outputs for the metric fns
            out.preds = forward(self, **batch).preds
        return out

    monkeypatch.setattr(NDT1, "forward", half)


def _altered_answer(monkeypatch):
    from llm_bci_tpu_torch import main

    make = main.make_cer_fns

    def altered(vocab, blank_id):
        train_cer, cer = make(vocab, blank_id)

        def wrong(*args, **kwargs):
            return train_cer(*args, **kwargs) + 1.0 / 64

        wrong.prepare = train_cer.prepare
        return wrong, cer

    monkeypatch.setattr(main, "make_cer_fns", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
def test_broken_timed_path_is_not_correct(fault, shrink, monkeypatch):
    fault(monkeypatch)
    r = harness.run("ctc_train_chained", 41, 0.3, False, device="cpu", shrink=shrink,
                    log=open(os.devnull, "w"))
    assert r["correct"] is False, r["checks"]
