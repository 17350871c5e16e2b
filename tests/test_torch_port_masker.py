"""The port's masker against the JAX package's, on the CPU.

Deterministic modes (``co-smooth``, ``forward-pred``, ``region``, and
``inter-`` / ``intra-region`` through ``MaskerOverrides`` with ratio 0 or 1)
with ``zero_ratio=1`` equal the JAX outputs exactly. ``jax.random`` streams
cannot be reproduced from a ``torch.Generator``, so the stochastic modes are
held by structure and statistics: the masked fraction within 3 sigma of
``ratio``, whole channels / whole bins, the expansion width, the zero /
random-replace split, replacement values within ``[0, max]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_bci_tpu.models import masker as jm
from llm_bci_tpu_torch.models import masker as tm

B, T, N = 4, 30, 12


def spikes_np(seed=0):
    return np.random.default_rng(seed).poisson(2.0, size=(B, T, N)).astype(np.float32) + 1.0


REGIONS = np.tile(np.array([0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]), (B, 1)).astype(np.int64)


def both(cfg_kwargs, training=False, regions=None, jov=None, tov=None):
    x = spikes_np()
    jx, jmask = jm.apply_masker(
        jm.MaskerConfig(**cfg_kwargs), jnp.asarray(x), jax.random.PRNGKey(0), training,
        None if regions is None else jnp.asarray(regions), jov)
    tx, tmask = tm.apply_masker(
        tm.MaskerConfig(**cfg_kwargs), torch.from_numpy(x), torch.Generator().manual_seed(0),
        training, None if regions is None else torch.from_numpy(regions), tov)
    return x, (np.asarray(jx), np.asarray(jmask)), (tx.numpy(), tmask.numpy())


DETERMINISTIC = {
    "co-smooth": (dict(mode="co-smooth", channels=(1, 5, 11)), None, None, None),
    "forward-pred": (dict(mode="forward-pred", timesteps=(0, 7, 29)), None, None, None),
    "region": (dict(mode="region", mask_region_ids=(1,)), REGIONS, None, None),
    "co-smooth-override": (
        dict(mode="co-smooth"), None,
        jm.MaskerOverrides(channels_onehot=jnp.asarray(np.eye(N)[3])),
        tm.MaskerOverrides(channels_onehot=torch.from_numpy(np.eye(N)[3]))),
    "forward-pred-override": (
        dict(mode="forward-pred"), None,
        jm.MaskerOverrides(timesteps_onehot=jnp.asarray(np.eye(T)[4])),
        tm.MaskerOverrides(timesteps_onehot=torch.from_numpy(np.eye(T)[4]))),
    "region-override": (
        dict(mode="region"), REGIONS,
        jm.MaskerOverrides(mask_region_sel=jnp.asarray(REGIONS == 2)),
        tm.MaskerOverrides(mask_region_sel=torch.from_numpy(REGIONS == 2))),
    # ratio 1: every channel of the selected regions is masked
    "inter-region-override": (
        dict(mode="inter-region", ratio=1.0), REGIONS,
        jm.MaskerOverrides(mask_region_sel=jnp.asarray(REGIONS == 0)),
        tm.MaskerOverrides(mask_region_sel=torch.from_numpy(REGIONS == 0))),
    # ratio 0 (given as a tiny value: from_config maps 0 to 0): everything
    # outside the target region is masked, targets inside it: none
    "intra-region-override": (
        dict(mode="intra-region", ratio=1.0), REGIONS,
        jm.MaskerOverrides(target_region_sel=jnp.asarray(REGIONS == 1)),
        tm.MaskerOverrides(target_region_sel=torch.from_numpy(REGIONS == 1))),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_modes_equal_jax(name):
    kwargs, regions, jov, tov = DETERMINISTIC[name]
    x, (jx, jmask), (tx, tmask) = both(dict(kwargs, force_active=True, zero_ratio=1.0),
                                       regions=regions, jov=jov, tov=tov)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tx, jx)
    assert tmask.dtype == np.int32 and 0 < tmask.sum() < tmask.size
    if name != "intra-region-override":
        np.testing.assert_array_equal(tx, np.where(tmask > 0, 0.0, x))


@pytest.mark.parametrize("kwargs,training", [
    (dict(mode="random", active=False), True),
    (dict(mode="random", active=True), False),          # eval without force_active
])
def test_inactive_is_identity(kwargs, training):
    x, (jx, jmask), (tx, tmask) = both(kwargs, training=training)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(tx, jx)
    assert tmask.sum() == 0 and jmask.sum() == 0 and tmask.dtype == np.int32


def run(cfg, shape=(8, 200, 64), seed=0, regions=None, value=3.0):
    x = torch.full(shape, value)
    x[0, 0, 0] = 5.0                     # the max, for the random replacement
    out, mask = tm.apply_masker(cfg, x, torch.Generator().manual_seed(seed), True, regions)
    return x, out, mask.bool()


def within_3_sigma(count, n, p):
    return abs(count - n * p) <= 3.0 * np.sqrt(n * p * (1 - p)) + 1.0


def test_random_mode_fraction_and_zeroing():
    x, out, mask = run(tm.MaskerConfig(mode="random", ratio=0.3))
    assert within_3_sigma(int(mask.sum()), mask.numel(), 0.3)
    assert (out[mask] == 0).all() and torch.equal(out[~mask], x[~mask])
    # a second seed masks other bins; the same seed the same ones
    assert not torch.equal(run(tm.MaskerConfig(mode="random", ratio=0.3), seed=1)[2], mask)
    assert torch.equal(run(tm.MaskerConfig(mode="random", ratio=0.3), seed=0)[2], mask)


def test_neuron_mode_masks_whole_channels():
    _, _, mask = run(tm.MaskerConfig(mode="neuron", ratio=0.25))
    per_channel = mask.float().mean(1)                     # (B, N)
    assert set(per_channel.unique().tolist()) <= {0.0, 1.0}
    assert within_3_sigma(int(per_channel.sum()), per_channel.numel(), 0.25)


@pytest.mark.parametrize("expand_prob,max_timespan", [(0.0, 1), (1.0, 5)])
def test_temporal_mode_masks_whole_bins_and_expands(expand_prob, max_timespan):
    cfg = tm.MaskerConfig(mode="temporal", ratio=0.2, expand_prob=expand_prob,
                          max_timespan=max_timespan)
    widths = set()
    for seed in range(8):
        _, _, mask = run(cfg, shape=(4, 400, 6), seed=seed)
        per_bin = mask.float().mean(2)                     # (B, T)
        assert set(per_bin.unique().tolist()) <= {0.0, 1.0}
        # the per-bin rate shrinks by the span: the masked share stays near
        # ratio (below it where dilated windows overlap)
        assert 0.08 < per_bin.mean().item() < 0.26
        runs = "".join("1" if v else "0" for v in per_bin[0].tolist()).split("0")
        widths.add(min(len(r) for r in runs if r))
    if max_timespan == 1:
        assert widths == {1}
    else:
        assert widths <= set(range(1, max_timespan + 1)) and max(widths) > 1


def test_expand_timesteps_matches_jax():
    m = (np.random.default_rng(0).random((3, 40)) < 0.1).astype(np.int32)
    for span in range(1, 6):
        ref = jm._expand_timesteps_dynamic(jnp.asarray(m), jnp.asarray(span), 5)
        out = tm._expand_timesteps_dynamic(torch.from_numpy(m), span, 5)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_zero_and_random_ratio_split():
    cfg = tm.MaskerConfig(mode="random", ratio=0.5, zero_ratio=0.6, random_ratio=0.5)
    x, out, mask = run(cfg)
    n = int(mask.sum())
    zeroed = mask & (out == 0)
    kept = mask & (out == x)
    replaced = mask & ~zeroed & ~kept
    assert within_3_sigma(int(zeroed.sum()), n, 0.6)
    assert within_3_sigma(int(replaced.sum()), n, 0.4 * 0.5)
    assert within_3_sigma(int(kept.sum()), n, 0.4 * 0.5)
    vals = out[replaced]
    assert vals.min() >= 0.0 and 2.5 < vals.max() <= 5.0
    assert torch.equal(out[~mask], x[~mask])


def test_replacement_scale_is_the_max_after_zeroing():
    # one large value in the masked channel: when it is zeroed, the
    # replacements are scaled by the remaining max (3), not by 100
    cfg = tm.MaskerConfig(mode="co-smooth", channels=(0,), force_active=True, zero_ratio=0.5)
    x = torch.full((2, 100, 4), 3.0)
    x[0, 0, 0] = 100.0
    seen = set()
    for seed in range(12):
        out, _ = tm.apply_masker(cfg, x, torch.Generator().manual_seed(seed), False)
        zeroed = out[0, 0, 0].item() == 0.0
        seen.add(zeroed)
        if zeroed:
            assert out.max().item() <= 3.0
        else:
            assert out[:, :, 0].max().item() > 3.0
    assert seen == {True, False}


@pytest.mark.parametrize("mode", ["inter-region", "intra-region"])
def test_region_sampling_modes(mode):
    regions = torch.from_numpy(np.tile(np.arange(64) // 16, (8, 1)))     # 4 regions of 16
    cfg = tm.MaskerConfig(mode=mode, ratio=0.5, mask_region_ids=(0, 1, 2, 3),
                          target_region_ids=(0, 1, 2, 3), n_mask_regions=1)
    picked = set()
    for seed in range(6):
        _, out, mask = run(cfg, seed=seed, regions=regions)
        per_channel = mask.float().mean(1)                                # (B, N)
        assert set(per_channel.unique().tolist()) <= {0.0, 1.0}
        by_region = per_channel.reshape(8, 4, 16).sum((0, 2))             # targets a region
        assert (by_region > 0).sum() == 1            # one sampled region holds the targets
        r = int(by_region.argmax())
        picked.add(r)
        assert within_3_sigma(int(by_region[r]), 8 * 16, 0.5)
        if mode == "intra-region":
            # everything outside the target region is zeroed
            outside = regions != r
            assert (out[:, :, :][outside[:, None, :].expand_as(out)] == 0).all()
    assert len(picked) > 1
    with pytest.raises(ValueError, match="region"):
        tm.apply_masker(cfg, torch.ones(2, 3, 4), None, True)


def test_apply_maskers_ors_the_targets():
    x = spikes_np()
    cfgs = [dict(mode="co-smooth", channels=(2,), force_active=True),
            dict(mode="forward-pred", timesteps=(3, 4), force_active=True),
            dict(mode="random", active=False)]
    jx, jmask = jm.apply_maskers([jm.MaskerConfig(**c) for c in cfgs], jnp.asarray(x),
                                 jax.random.PRNGKey(0), False)
    tx, tmask = tm.apply_maskers([tm.MaskerConfig(**c) for c in cfgs], torch.from_numpy(x),
                                 torch.Generator().manual_seed(0), False)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    want = np.zeros((B, T, N), bool)
    want[:, :, 2] = True
    want[:, 3:5, :] = True
    np.testing.assert_array_equal(tmask.numpy().astype(bool), want)
    # an override reaches the masker of its index
    tx2, tmask2 = tm.apply_maskers(
        [tm.MaskerConfig(**c) for c in cfgs], torch.from_numpy(x), None, False,
        overrides={0: tm.MaskerOverrides(channels_onehot=torch.from_numpy(np.eye(N)[7]))})
    assert tmask2[:, 0, 7].all() and not tmask2[:, 0, 2].any()


def test_masker_config_from_config_matches_jax():
    cfg = {"mode": "region", "active": True, "ratio": None, "regions": ["CA1", "PO"],
           "channels": [1, 2], "expand_prob": None, "max_timespan": None, "zero_ratio": 0.8}
    vocab = {"CA1": 3, "PO": 5}
    ours = tm.MaskerConfig.from_config(cfg, vocab)
    ref = jm.MaskerConfig.from_config(cfg, vocab)
    assert vars(ours) == vars(ref)
    with pytest.raises(ValueError, match="region_to_id"):
        tm.MaskerConfig.from_config(cfg)
