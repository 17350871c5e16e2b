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
device (``None`` reads torch's global RNG). Under sequence parallelism
(``time``: the bins a rank holds of the whole sequence's) every draw is made
at the whole sequence's shape and sliced, so that the ranks of one sequence,
whose generators move in lockstep, mask what one device masks, and the
maximum of the random replacement is taken over the ranks (``reduce_max``). The streams differ from
``jax.random``'s: for one seed the two packages mask different bins with the
same statistics; the deterministic modes give identical results. Region
names never reach the device: the caller resolves them to integer ids and
passes ``neuron_regions_idx`` ``(B, N)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from llm_bci_tpu_torch.ops.attention import TimeSlice


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


_IDS_ON_DEVICE: Dict[tuple, torch.Tensor] = {}


def _pick_regions(cand: Sequence[int], n: int, generator, like: torch.Tensor) -> torch.Tensor:
    """``n`` of the candidate ids, without replacement, on ``like``'s
    device. The ids go there once (a train step that a CUDA graph holds
    copies nothing from the host); a trace (fake tensors) makes its own."""
    device = like.device
    if type(like) is not torch.Tensor:
        ids = torch.as_tensor(list(cand), device=device)
    else:
        key = (tuple(cand), str(device))
        if key not in _IDS_ON_DEVICE:
            _IDS_ON_DEVICE[key] = torch.as_tensor(list(cand), device=device)
        ids = _IDS_ON_DEVICE[key]
    perm = torch.randperm(len(ids), generator=generator, device=device)
    return ids[perm[:n]]


def apply_masker(
    cfg: MaskerConfig,
    spikes: torch.Tensor,                       # (B, T, N)
    generator: Optional[torch.Generator],
    training: bool,
    neuron_regions_idx: Optional[torch.Tensor] = None,  # (B, N) int region ids
    overrides: Optional[MaskerOverrides] = None,
    time: Optional[TimeSlice] = None,
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(masked_spikes, targets_mask)``; ``targets_mask`` is int32,
    1 on bins the model must reconstruct. With ``time``, ``spikes`` holds
    those bins of a sequence of ``time.total``: the masks are drawn for the
    whole sequence and sliced, and ``reduce_max`` takes the maximum over the
    ranks that hold the rest."""
    B, T_local, N = spikes.shape
    T = T_local if time is None else time.total
    start = 0 if time is None else time.start
    dev = spikes.device
    ov = overrides or MaskerOverrides()

    def part(m: torch.Tensor) -> torch.Tensor:     # (B, T, ...) -> the rank's bins
        return m if time is None else m[:, start:start + T_local]

    if not cfg.active or (not training and not cfg.force_active):
        return spikes, torch.zeros(spikes.shape, dtype=torch.int32, device=dev)

    mode = cfg.mode
    intra_targets_sel = None  # (B, N) bool, intra-region only

    if mode == "temporal":
        # The per-bin ratio shrinks by the span, so that the expected masked
        # fraction stays about ``ratio``.
        flip = _bernoulli(cfg.expand_prob, (), generator, dev)
        # a probability of 0 or 1 decides without reading the draw back, so
        # that a CUDA graph can hold the step (training.chain_steps)
        sure = cfg.expand_prob <= 0.0 or cfg.expand_prob >= 1.0
        expand = cfg.expand_prob >= 1.0 if sure else bool(flip)
        timespan = (
            int(torch.randint(1, cfg.max_timespan + 1, (), generator=generator, device=dev))
            if expand else 1
        )
        mask_bt = _bernoulli(cfg.ratio / timespan, (B, T), generator, dev)
        mask_bt = _expand_timesteps_dynamic(mask_bt.to(torch.int32), timespan,
                                            cfg.max_timespan) > 0
        mask = part(mask_bt)[:, :, None].expand(B, T_local, N)
    elif mode == "neuron":
        mask = _bernoulli(cfg.ratio, (B, N), generator, dev)[:, None, :].expand(B, T_local, N)
    elif mode == "random":
        mask = part(_bernoulli(cfg.ratio, (B, T, N), generator, dev))
    elif mode == "region":
        if neuron_regions_idx is None:
            raise ValueError("Can't mask region without brain region information")
        sel = (
            ov.mask_region_sel.bool()
            if ov.mask_region_sel is not None
            else _isin(neuron_regions_idx, cfg.mask_region_ids or ())
        )
        mask = sel[:, None, :].expand(B, T_local, N)
    elif mode == "co-smooth":
        if ov.channels_onehot is not None:
            onehot = ov.channels_onehot.bool()
        else:
            if cfg.channels is None:
                raise ValueError("No channels to mask")
            onehot = _isin(torch.arange(N, device=dev), cfg.channels)
        rows = onehot if onehot.dim() == 2 else onehot[None, :]     # (B or 1, N)
        mask = rows[:, None, :].expand(B, T_local, N)
    elif mode == "forward-pred":
        if ov.timesteps_onehot is not None:
            onehot = ov.timesteps_onehot.bool()
        else:
            if cfg.timesteps is None:
                raise ValueError("No time steps to mask")
            onehot = _isin(torch.arange(T, device=dev), cfg.timesteps)
        mask = onehot[start:start + T_local][None, :, None].expand(B, T_local, N)
    elif mode in ("inter-region", "intra-region"):
        if neuron_regions_idx is None:
            raise ValueError("Can't mask region without brain region information")
        intra = mode == "intra-region"
        override = ov.target_region_sel if intra else ov.mask_region_sel
        if override is not None:
            sel = override.bool()
        else:
            cand = cfg.target_region_ids if intra else cfg.mask_region_ids
            picked = _pick_regions(cand, cfg.n_mask_regions, generator, spikes)
            sel = (neuron_regions_idx[..., None] == picked).any(-1)
        # inter: a ``ratio`` fraction of the picked regions' channels.
        # intra: everything outside the target region, and a ``ratio``
        # fraction inside it; targets live inside the region only.
        outside = 1.0 if intra else 0.0
        probs = torch.where(sel, torch.full_like(sel, cfg.ratio, dtype=torch.float32),
                            torch.full_like(sel, outside, dtype=torch.float32))
        mask = _bernoulli(probs, (B, N), generator, dev)[:, None, :].expand(B, T_local, N)
        if intra:
            intra_targets_sel = sel
    else:
        raise ValueError(f"Masking mode {mode} not implemented")

    # Corrupt: zero a zero_ratio fraction; of the rest, replace random_ratio
    # with uniform draws scaled by the post-zeroing max.
    zero_idx = part(_bernoulli(cfg.zero_ratio, (B, T, N), generator, dev)) & mask
    spikes = torch.where(zero_idx, torch.zeros_like(spikes), spikes)
    random_idx = part(_bernoulli(cfg.random_ratio, (B, T, N), generator, dev)) & mask & ~zero_idx
    # The max spans the whole batch. Where a batch holds several examples'
    # copies (the co-smoothing sweep's folded points) that couples them, but
    # only through ``random_idx``, which is empty under ``zero_ratio = 1``:
    # every masker of that sweep has it (``eval/co_smoothing.py``).
    top = spikes.max()
    if reduce_max is not None:
        top = reduce_max(top).to(spikes.dtype)
    random_spikes = top * part(torch.rand(
        (B, T, N), generator=generator, device=dev, dtype=spikes.dtype
    ))
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
    time: Optional[TimeSlice] = None,
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply a list of maskers in sequence, OR-ing their target masks.
    ``overrides`` maps masker index -> :class:`MaskerOverrides`; ``time`` and
    ``reduce_max`` as in :func:`apply_masker`."""
    targets_mask = torch.zeros(spikes.shape, dtype=torch.int32, device=spikes.device)
    for i, cfg in enumerate(cfgs):
        ov = (overrides or {}).get(i)
        spikes, new_mask = apply_masker(cfg, spikes, generator, training, neuron_regions_idx, ov,
                                        time, reduce_max)
        targets_mask = targets_mask | new_mask
    return spikes, targets_mask
