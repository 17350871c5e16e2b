"""Spike masking for self-supervised objectives (counterpart of
``llm_bci_tpu/models/masker.py``).

Modes:

* ``temporal``  — mask whole timesteps; optional consecutive-bin expansion
* ``neuron``    — mask whole channels
* ``random``    — mask individual (t, n) bins
* ``region``    — mask all channels in configured brain regions
* ``co-smooth`` — mask a fixed channel set
* ``forward-pred`` — mask a fixed timestep set
* ``inter-region`` — mask ``n_mask_regions`` sampled regions
* ``intra-region`` — mask everything except a sampled target region (plus a
  ``ratio`` fraction inside it); targets restricted to the target region

Masked bins are zeroed with probability ``zero_ratio``; of the remainder,
``random_ratio`` are replaced by uniform values in ``[0, spikes.max()]``
(the max is taken after zeroing).

Every draw comes from an explicit ``torch.Generator`` on the tensor's
device (``None`` reads torch's global RNG). The streams differ from
``jax.random``'s: for one seed the two packages mask different bins with the
same statistics; the deterministic modes give identical results. Region
names never reach the device: the caller resolves them to integer ids and
passes ``neuron_regions_idx`` ``(B, N)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MaskerConfig:
    """Static masker configuration."""

    mode: str = "random"
    active: bool = True
    force_active: bool = False
    ratio: float = 0.1
    zero_ratio: float = 1.0
    random_ratio: float = 1.0
    expand_prob: float = 0.0
    max_timespan: int = 1
    channels: Optional[Tuple[int, ...]] = None        # co-smooth
    timesteps: Optional[Tuple[int, ...]] = None       # forward-pred
    mask_region_ids: Optional[Tuple[int, ...]] = None    # region / inter-region
    target_region_ids: Optional[Tuple[int, ...]] = None  # intra-region
    n_mask_regions: int = 1

    @classmethod
    def from_config(cls, cfg, region_to_id=None) -> "MaskerConfig":
        """Build from a mapping; region names in ``regions`` /
        ``mask_regions`` / ``target_regions`` are resolved to integer ids
        via ``region_to_id``."""

        def ids(names):
            if names is None:
                return None
            if len(names) and region_to_id is None:
                raise ValueError("Region-based masking needs a region_to_id vocabulary")
            return tuple(int(region_to_id[r]) for r in names)

        def tup(xs):
            return None if xs is None else tuple(int(x) for x in xs)

        return cls(
            mode=cfg.get("mode", "random"),
            active=bool(cfg.get("active", True)),
            force_active=bool(cfg.get("force_active", False)),
            ratio=float(cfg.get("ratio", 0.1) or 0.0),
            zero_ratio=float(cfg.get("zero_ratio", 1.0)),
            random_ratio=float(cfg.get("random_ratio", 1.0)),
            expand_prob=float(cfg.get("expand_prob", 0.0) or 0.0),
            max_timespan=int(cfg.get("max_timespan", 1) or 1),
            channels=tup(cfg.get("channels")),
            timesteps=tup(cfg.get("timesteps")),
            mask_region_ids=ids(cfg.get("mask_regions") or cfg.get("regions")),
            target_region_ids=ids(cfg.get("target_regions")),
            n_mask_regions=int(cfg.get("n_mask_regions", 1) or 1),
        )


@dataclasses.dataclass
class MaskerOverrides:
    """Selection overrides for eval harnesses: ``channels_onehot`` replaces
    the static co-smooth channel set, one ``(N,)`` set for the whole batch or
    one ``(B, N)`` row for each example (the co-smoothing sweep folds its
    points into the batch that way), ``timesteps_onehot (T,)`` the
    forward-pred timesteps, ``mask_region_sel`` / ``target_region_sel``
    ``(B, N)`` (or ``(1, N)``) replace region sampling."""

    channels_onehot: Optional[torch.Tensor] = None
    timesteps_onehot: Optional[torch.Tensor] = None
    mask_region_sel: Optional[torch.Tensor] = None
    target_region_sel: Optional[torch.Tensor] = None


def _bernoulli(probs, shape, generator, device) -> torch.Tensor:
    """Bool draws with probability ``probs`` (a float or a tensor of ``shape``)."""
    return torch.rand(shape, generator=generator, device=device) < probs


def _expand_timesteps_dynamic(mask: torch.Tensor, timespan: int, max_timespan: int
                              ) -> torch.Tensor:
    """OR-dilate a (B, T) mask with a centred window of width ``timespan``
    <= ``max_timespan``: offsets ``-(timespan-1)//2 .. timespan//2``."""
    lo = -((timespan - 1) // 2)
    hi = timespan // 2
    out = torch.zeros_like(mask)
    for j in range(-((max_timespan - 1) // 2), max_timespan // 2 + 1):
        if not lo <= j <= hi:
            continue
        if j == 0:
            shifted = mask
        elif j > 0:
            shifted = torch.nn.functional.pad(mask[:, j:], (0, j))
        else:
            shifted = torch.nn.functional.pad(mask[:, :j], (-j, 0))
        out = torch.maximum(out, shifted)
    return out


def _isin(x: torch.Tensor, ids) -> torch.Tensor:
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for i in ids:
        out |= x == i
    return out


def _pick_regions(cand: Sequence[int], n: int, generator, device) -> torch.Tensor:
    """``n`` of the candidate ids, without replacement."""
    cand = torch.as_tensor(list(cand), device=device)
    perm = torch.randperm(len(cand), generator=generator, device=device)
    return cand[perm[:n]]


def apply_masker(
    cfg: MaskerConfig,
    spikes: torch.Tensor,                       # (B, T, N)
    generator: Optional[torch.Generator],
    training: bool,
    neuron_regions_idx: Optional[torch.Tensor] = None,  # (B, N) int region ids
    overrides: Optional[MaskerOverrides] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(masked_spikes, targets_mask)``; ``targets_mask`` is int32,
    1 on bins the model must reconstruct."""
    B, T, N = spikes.shape
    dev = spikes.device
    ov = overrides or MaskerOverrides()

    if not cfg.active or (not training and not cfg.force_active):
        return spikes, torch.zeros(spikes.shape, dtype=torch.int32, device=dev)

    mode = cfg.mode
    intra_targets_sel = None  # (B, N) bool, intra-region only

    if mode == "temporal":
        # The per-bin ratio shrinks by the span, so that the expected masked
        # fraction stays about ``ratio``.
        expand = bool(_bernoulli(cfg.expand_prob, (), generator, dev))
        timespan = (
            int(torch.randint(1, cfg.max_timespan + 1, (), generator=generator, device=dev))
            if expand else 1
        )
        mask_bt = _bernoulli(cfg.ratio / timespan, (B, T), generator, dev)
        mask_bt = _expand_timesteps_dynamic(mask_bt.to(torch.int32), timespan,
                                            cfg.max_timespan) > 0
        mask = mask_bt[:, :, None].expand(B, T, N)
    elif mode == "neuron":
        mask = _bernoulli(cfg.ratio, (B, N), generator, dev)[:, None, :].expand(B, T, N)
    elif mode == "random":
        mask = _bernoulli(cfg.ratio, (B, T, N), generator, dev)
    elif mode == "region":
        if neuron_regions_idx is None:
            raise ValueError("Can't mask region without brain region information")
        sel = (
            ov.mask_region_sel.bool()
            if ov.mask_region_sel is not None
            else _isin(neuron_regions_idx, cfg.mask_region_ids or ())
        )
        mask = sel[:, None, :].expand(B, T, N)
    elif mode == "co-smooth":
        if ov.channels_onehot is not None:
            onehot = ov.channels_onehot.bool()
        else:
            if cfg.channels is None:
                raise ValueError("No channels to mask")
            onehot = _isin(torch.arange(N, device=dev), cfg.channels)
        rows = onehot if onehot.dim() == 2 else onehot[None, :]     # (B or 1, N)
        mask = rows[:, None, :].expand(B, T, N)
    elif mode == "forward-pred":
        if ov.timesteps_onehot is not None:
            onehot = ov.timesteps_onehot.bool()
        else:
            if cfg.timesteps is None:
                raise ValueError("No time steps to mask")
            onehot = _isin(torch.arange(T, device=dev), cfg.timesteps)
        mask = onehot[None, :, None].expand(B, T, N)
    elif mode in ("inter-region", "intra-region"):
        if neuron_regions_idx is None:
            raise ValueError("Can't mask region without brain region information")
        intra = mode == "intra-region"
        override = ov.target_region_sel if intra else ov.mask_region_sel
        if override is not None:
            sel = override.bool()
        else:
            cand = cfg.target_region_ids if intra else cfg.mask_region_ids
            picked = _pick_regions(cand, cfg.n_mask_regions, generator, dev)
            sel = (neuron_regions_idx[..., None] == picked).any(-1)
        # inter: a ``ratio`` fraction of the picked regions' channels.
        # intra: everything outside the target region, and a ``ratio``
        # fraction inside it; targets live inside the region only.
        outside = 1.0 if intra else 0.0
        probs = torch.where(sel, torch.full_like(sel, cfg.ratio, dtype=torch.float32),
                            torch.full_like(sel, outside, dtype=torch.float32))
        mask = _bernoulli(probs, (B, N), generator, dev)[:, None, :].expand(B, T, N)
        if intra:
            intra_targets_sel = sel
    else:
        raise ValueError(f"Masking mode {mode} not implemented")

    # Corrupt: zero a zero_ratio fraction; of the rest, replace random_ratio
    # with uniform draws scaled by the post-zeroing max.
    zero_idx = _bernoulli(cfg.zero_ratio, (B, T, N), generator, dev) & mask
    spikes = torch.where(zero_idx, torch.zeros_like(spikes), spikes)
    random_idx = _bernoulli(cfg.random_ratio, (B, T, N), generator, dev) & mask & ~zero_idx
    # The max spans the whole batch. Where a batch holds several examples'
    # copies (the co-smoothing sweep's folded points) that couples them, but
    # only through ``random_idx``, which is empty under ``zero_ratio = 1``:
    # every masker of that sweep has it (``eval/co_smoothing.py``).
    random_spikes = spikes.max() * torch.rand(
        (B, T, N), generator=generator, device=dev, dtype=spikes.dtype
    )
    spikes = torch.where(random_idx, random_spikes, spikes)

    targets_mask = mask
    if intra_targets_sel is not None:
        targets_mask = mask & intra_targets_sel[:, None, :]
    return spikes, targets_mask.to(torch.int32)


def apply_maskers(
    cfgs: Sequence[MaskerConfig],
    spikes: torch.Tensor,
    generator: Optional[torch.Generator],
    training: bool,
    neuron_regions_idx: Optional[torch.Tensor] = None,
    overrides: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a list of maskers in sequence, OR-ing their target masks.
    ``overrides`` maps masker index -> :class:`MaskerOverrides`."""
    targets_mask = torch.zeros(spikes.shape, dtype=torch.int32, device=spikes.device)
    for i, cfg in enumerate(cfgs):
        ov = (overrides or {}).get(i)
        spikes, new_mask = apply_masker(cfg, spikes, generator, training, neuron_regions_idx, ov)
        targets_mask = targets_mask | new_mask
    return spikes, targets_mask
