"""Co-smoothing: the port's ``eval/co_smoothing.py`` against the JAX package's.

A JAX ``Trainer`` and a port ``Trainer`` on the same config and test set (the
shapes of ``tests/test_eval.py``: T=20, N=12 in 3 regions, 2 layers, narrow),
the JAX params carried across by ``ndt1_state_dict_from_jax``, float32, on the
CPU. Every mode's bits-per-spike within atol 1e-4 (NaN where the JAX package
gives NaN), the held-out log-rates within rtol 1e-5 (float32 sums in another
order), and the port's folded sweep (K points in one batch) equal to K passes
of one point. The flash case runs the JAX Pallas kernel in interpret mode and
the port the plain version of its CUDA kernels, on the same weights.
"""
import copy
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from llm_bci_tpu.config import DictConfig, to_plain_dict, update_config
from llm_bci_tpu_torch.config import DictConfig as PortDictConfig

T, N, REGIONS = 20, 12, ("R0", "R1", "R2")
ATOL_BPS = 1e-4


def dataset(seed=0):
    """Spikes with region labels and the conditions of an aligned session."""
    rng = np.random.default_rng(seed)

    def rows(n):
        return [{"spikes": rng.poisson(1.0, size=(T, N)).astype(np.float32),
                 "neuron_regions": [REGIONS[i % 3] for i in range(N)],
                 "choice": np.atleast_1d(float(rng.choice([-1.0, 1.0]))),
                 "reward": np.atleast_1d(float(rng.choice([0.0, 1.0]))),
                 "block": np.atleast_1d(float(rng.choice([0.2, 0.5, 0.8])))}
                for _ in range(n)]

    return {"train": rows(8), "test": rows(8)}


def config(tmp_path):
    pad = lambda: {"dim": 0, "side": "left", "value": 0, "truncate": None, "min_length": None}
    return DictConfig({
        "savestring": "cosmooth", "verbosity": 3, "seed": 0,
        "dirs": {"checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": None},
        "training": {"num_epochs": 1, "train_batch_size": 8, "test_batch_size": 8,
                     "max_steps": 1, "save_on_preemption": False},
        "model": update_config("configs/ndt1.yaml", {"encoder": {
            "masker": {"neuron": {"active": True, "mode": "random", "ratio": 0.3}},
            "smooth_and_noise": {"smooth_sd": 1, "white_noise_sd": 0.1,
                                 "constant_offset_sd": 0.1},
            "embedder": {"n_channels": N, "max_F": T, "input_dim": 16,
                         "stack": {"active": False}, "dropout": 0.1},
            "transformer": {"n_layers": 2, "hidden_size": 16, "n_heads": 2, "inter_size": 32,
                            "dropout": 0.1},
        }}),
        "data": {"dataset_class": "base"},
        "method": {
            "model_kwargs": {"method_name": "mlm", "loss": "poisson_nll", "log_input": True},
            "dataset_kwargs": {},
            "dataloader_kwargs": {"pad_dict": {
                k: pad() for k in ("spikes", "spikes_mask", "spikes_timestamp")}},
            "metric_kwargs": {},
        },
        "optimizer": {"lr": 1e-3, "scheduler": "cosine", "warmup_pct": 0.1},
        "precision": {"compute_dtype": "float32"},
    })


def trainers(tmp_path):
    from llm_bci_tpu.training.trainer import Trainer as JaxTrainer
    from llm_bci_tpu_torch.interop import ndt1_state_dict_from_jax
    from llm_bci_tpu_torch.training.trainer import Trainer as PortTrainer

    ds = dataset()
    jt = JaxTrainer(config(tmp_path / "jax"), dataset=ds)
    pt = PortTrainer(PortDictConfig(to_plain_dict(config(tmp_path / "port"))),
                     dataset=ds, device="cpu")
    pt.model.load_state_dict(ndt1_state_dict_from_jax(jax.device_get(jt.state.params)),
                             strict=True)
    return jt, pt


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return trainers(tmp_path_factory.mktemp("cosmooth"))


def assert_bps_equal(port, ref):
    assert len(port) == len(ref) > 0
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_allclose(port[~np.isnan(ref)], ref[~np.isnan(ref)], atol=ATOL_BPS, rtol=0)


@pytest.mark.parametrize("mode", ["neuron", "intra-region", "inter-region"])
def test_bits_per_spike_match_the_jax_package(pair, tmp_path, mode):
    from llm_bci_tpu.eval.co_smoothing import co_smoothing_eval as jax_eval
    from llm_bci_tpu_torch.eval.co_smoothing import co_smoothing_eval as port_eval

    jt, pt = pair
    kw = dict(save_path=str(tmp_path / "figs"), method="mlm", modes=[mode], max_N=3)
    ref, got = jax_eval(jt, **kw)[mode], port_eval(pt, **kw)[mode]
    assert_bps_equal(got["bps"], ref["bps"])
    assert got["r2"] == ref["r2"]
    assert pt.model.encoder.masker_cfgs[0].mode == "random"     # the maskers are restored


def jax_log_rates(jt, mode, points):
    """The JAX package's held-out log-rates, one eval a sweep point."""
    import jax.numpy as jnp

    from llm_bci_tpu.eval import co_smoothing as cs
    from llm_bci_tpu.models.masker import MaskerOverrides

    regions = np.asarray([REGIONS.index(r) for r in [REGIONS[i % 3] for i in range(N)]])
    maskers = {"neuron": {"main": dict(cs._COSMOOTH)},
               "intra-region": {"region": {"force_active": True, "mode": "intra-region",
                                           "ratio": 0.0, "zero_ratio": 1.0,
                                           "random_ratio": 1.0, "target_regions": []},
                                "main": dict(cs._COSMOOTH)}}[mode]
    model = cs._eval_model_with_maskers(jt.model, maskers)
    (inputs, _), = list(jt.test_dataloader)
    batch = {k: v for k, v in inputs.items() if isinstance(v, np.ndarray)}
    batch["neuron_regions_idx"] = np.tile(regions, (batch["spikes"].shape[0], 1))
    apply = jax.jit(lambda params, ovs: model.apply(
        {"params": params}, **batch, training=False, masker_overrides=ovs,
        rngs={"mask": jax.random.PRNGKey(0)}).preds)
    out = []
    for n in points:
        onehot = MaskerOverrides(channels_onehot=jnp.asarray(np.arange(N) == n))
        ovs = {0: onehot} if mode == "neuron" else {
            0: MaskerOverrides(target_region_sel=jnp.asarray((regions == regions[n])[None])),
            1: onehot}
        preds = apply(jt.state.params, ovs)
        out.append(np.asarray(preds)[:, :, n])
    return np.stack(out)


def port_rates(pt, mode, points, sweep_batch):
    from llm_bci_tpu_torch.eval import co_smoothing as cs

    batches, region_list = cs.sweep_inputs(pt)
    chunks = cs.run_sweep(pt, batches, cs.SWEEP_MASKERS[mode], cs.mode_overrides(mode, region_list),
                          points, channel_for=lambda n: n, sweep_batch=sweep_batch)
    return np.concatenate([rates for _, rates in chunks])


@pytest.mark.parametrize("mode", ["neuron", "intra-region"])
def test_log_rates_match_and_the_folded_sweep_equals_one_point_passes(pair, mode):
    jt, pt = pair
    points = [0, 4, 11]
    folded = port_rates(pt, mode, points, sweep_batch=3)
    one_by_one = port_rates(pt, mode, points, sweep_batch=1)
    assert folded.shape == (3, 8, T)
    np.testing.assert_array_equal(folded, one_by_one)
    np.testing.assert_allclose(np.log(folded), jax_log_rates(jt, mode, points), rtol=1e-5,
                               atol=1e-6)


def test_every_sweep_masker_zeroes_what_it_masks():
    """The folded batch shares ``spikes.max()`` in ``apply_masker``; that is
    harmless only while no masked bin is replaced by a random draw."""
    from llm_bci_tpu_torch.eval import co_smoothing as cs
    from llm_bci_tpu_torch.models.masker import MaskerConfig, MaskerOverrides, apply_masker

    cfgs = [c for block in cs.SWEEP_MASKERS.values() for c in block.values()]
    assert len(cfgs) == 4 and all(c["zero_ratio"] == 1.0 for c in cfgs)
    rng = np.random.default_rng(0)
    spikes = torch.from_numpy(rng.poisson(2.0, size=(6, 5, N)).astype(np.float32))
    spikes[3:] *= 10                    # the second copy's max is 10x the first's
    onehot = torch.from_numpy(np.stack([np.arange(N) == n for n in (2, 2, 2, 7, 7, 7)]))
    cfg = MaskerConfig.from_config(cs._COSMOOTH)
    gen = torch.Generator().manual_seed(0)
    folded, tmask = apply_masker(cfg, spikes, gen, False,
                                 overrides=MaskerOverrides(channels_onehot=onehot))
    for half, n in ((slice(0, 3), 2), (slice(3, 6), 7)):
        alone, amask = apply_masker(cfg, spikes[half], gen, False,
                                    overrides=MaskerOverrides(
                                        channels_onehot=torch.from_numpy(np.arange(N) == n)))
        assert torch.equal(folded[half], alone) and torch.equal(tmask[half], amask)
    # with random replacement the max would couple the copies: not a sweep masker
    noisy = MaskerConfig.from_config({**cs._COSMOOTH, "zero_ratio": 0.0})
    coupled, _ = apply_masker(noisy, spikes, gen, False,
                              overrides=MaskerOverrides(channels_onehot=onehot))
    assert float(coupled[:3, :, 2].max()) > float(spikes[:3].max())


def test_flash_path_matches_the_jax_pallas_kernel(pair, tmp_path):
    """The same trainers with both models switched to the flash path."""
    import types

    from llm_bci_tpu.eval.co_smoothing import co_smoothing_eval as jax_eval
    from llm_bci_tpu.ops import flash_attention as jfa
    from llm_bci_tpu_torch.eval.co_smoothing import co_smoothing_eval as port_eval

    jt, pt = pair
    cfg = copy.deepcopy(jt.model.config)
    cfg["encoder"]["transformer"]["flash_attention"] = True
    flash_jt = types.SimpleNamespace(model=dataclasses.replace(jt.model, config=cfg),
                                     state=jt.state, test_dataset=jt.test_dataset,
                                     test_dataloader=jt.test_dataloader)
    kw = dict(save_path=str(tmp_path / "figs"), method="mlm", modes=["neuron"], max_N=2)
    jfa.set_interpret_mode(True)
    try:
        ref = jax_eval(flash_jt, **kw)["neuron"]
    finally:
        jfa.set_interpret_mode(False)
    encoder = pt.model.encoder
    assert not encoder._use_flash_now(T)
    encoder.flash_mode = "on"
    try:
        assert encoder._use_flash_now(T)
        assert_bps_equal(port_eval(pt, **kw)["neuron"]["bps"], ref["bps"])
    finally:
        encoder.flash_mode = "auto"


def test_aligned_r2_plots_write_a_png(pair, tmp_path):
    """The aligned path's condition matrix and figures; its bits-per-spike
    are the unaligned path's (held against the JAX package above)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pytest.skip("matplotlib is not installed")
    from llm_bci_tpu_torch.eval.co_smoothing import co_smoothing_eval as port_eval

    _, pt = pair
    kw = dict(save_path=str(tmp_path / "figs"), method="mlm", modes=["neuron"], max_N=1)
    got = port_eval(pt, is_aligned=True, onset_alignment=[5], make_r2_plots=True, **kw)["neuron"]
    assert got["bps"] == port_eval(pt, **kw)["neuron"]["bps"]
    assert len(got["r2"]) == 1 and np.isfinite(got["r2"][0]).all()     # PSTH and trial R2
    assert any(f.endswith(".png") for f in os.listdir(tmp_path / "figs"))
