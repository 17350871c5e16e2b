"""The yardstick's operation counts: the model step's matrix products
against ``torch.utils.flop_counter`` on the reference at debug sizes (the
counter sees every product the forward and backward run), and the roofline
bounds' arithmetic."""
import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
import work
from reference import common
from reference import data as ref_data
from reference import ndt1 as ref


@pytest.mark.parametrize("cell", ["ctc_train", "mlm_train_t1024"])
def test_step_flops_match_the_flop_counter(cell, shrink):
    spec = harness.cell_spec(cell)
    config, traffic = copy.deepcopy(spec["config"]), copy.deepcopy(spec["traffic"])
    shrink(config, traffic)
    import traffic as traffic_mod

    vocab = config.get("vocab")
    trials = traffic_mod.make_trials(config, traffic, 3, torch.device("cpu"), vocab)
    model = config["trainer"]["model"]
    n_channels = trials["train"][0]["spikes"].shape[1]
    n_out = len(vocab) if vocab else n_channels
    params = {k: v.requires_grad_(True) for k, v in
              common.make_weights(ref.param_spec(model, n_channels, n_out), 3, "cpu").items()}
    side = config["trainer"]["method"]["dataloader_kwargs"]["pad_dict"]["spikes"]["side"]
    widths = ref_data.pad_widths(trials)
    rows = trials["train"][:4]
    batch = ref_data.batch(rows, widths, side, "cpu")
    gen = torch.Generator().manual_seed(1)
    with FlopCounterMode(display=False) as counter:
        loss, _, _ = ref.forward(params, batch, model, config["method"], gen, common.Precision())
        loss.backward()
    want = len(rows) * ref.step_flops_per_sample(model, widths["bins"], n_channels, n_out)
    assert counter.get_total_flops() == pytest.approx(want, rel=1e-9)


def test_bounds():
    # bytes bound the CTC loss: log-probs read and gradient written, float32
    t = work.ctc_fused_bound_s(64, 121, 41, 64)
    assert t == pytest.approx((2 * 64 * 121 * 41 * 4 + 64 * 64 * 4 + 64 * 12) / work.PEAK_BYTES)
    # operations bound attention at T = 1024, D = 128
    lengths = [1024] * 32
    t = work.flash_bound_s(lengths, 1024, 8, 128, 5)
    assert t == pytest.approx(5 * 14.0 * 32 * 8 * 1024 * 1024 * 128 / work.PEAK_OPS["bfloat16"])
    assert work.bound_s(1.0, 0.0, "float32") == 1.0 / 67e12
