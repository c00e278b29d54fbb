"""Adaptive density control: gradient-driven clone/split + opacity pruning
(port of fourdgs/train/densify.py).

Static capacity, as in the reference: the parameter dict never changes
length inside a fit. Pruning frees slots (alpha -> 0) and densification
fills freed slots with clones / splits of the highest-gradient splats;
capacity grows only between fits (`pad_params`).

Mechanism (Kerbl et al.'s 3DGS adaptive control on the motion
parameterization):
  * accumulate the norm of dL/d(spatial position) per splat across steps;
  * splats with average gradient above `grad_thresh` are candidates:
    *split* if their largest scale exceeds `split_scale`, else *clone*;
  * splats with opacity below `prune_alpha` are pruned;
  * the k-th best candidate fills the k-th freed slot: argsort, gather and
    scatter, no data-dependent shapes and no read back to the host.

`densify_step` writes the new parameters into the given tensors in place
(under no_grad), so an optimizer that holds them keeps holding them; its
moments are reset by `reset_opt_slots`. The split children's offsets are
the only random numbers: `normal_draws` takes them from a torch.Generator,
which cannot give jax.random's numbers, so parity tests replace it with
the reference's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from fourdgs_torch import resolve_device
from fourdgs_torch.splats.packed import rot_from_quat


@dataclasses.dataclass(frozen=True)
class DensifyState:
    """Per-splat gradient statistics accumulated between densify events."""
    grad_accum: torch.Tensor   # (N,) summed ||dL/d position||
    steps: torch.Tensor        # () int32 number of accumulated steps


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """The reference's knobs and defaults; fourdgs/train/densify.py
    documents the measured trade-off of `opt_reset` ("slots": zero Adam
    moments at changed slots only; "all": a new optimizer, step count
    included)."""
    grad_thresh: float = 2e-6
    split_scale: float = 2.0
    split_factor: float = 1.6
    prune_alpha: float = 5e-3
    opt_reset: str = "slots"    # "slots" | "all"


def init_state(n: int, dtype=torch.float32, device=None) -> DensifyState:
    """Zero statistics for n slots on `device` (None: the card,
    fourdgs_torch.default_device)."""
    device = resolve_device(device)
    return DensifyState(
        grad_accum=torch.zeros((n,), dtype=dtype, device=device),
        steps=torch.zeros((), dtype=torch.int32, device=device))


def accumulate(state: DensifyState,
               grads: Dict[str, torch.Tensor]) -> DensifyState:
    """Fold one step's gradients (the trainer's layout: position4 (N, 4),
    ...) into the statistics: the spatial-position gradient norm is the
    reconstruction-pressure signal."""
    g = grads["position4"][:, :3]
    return DensifyState(
        grad_accum=state.grad_accum + torch.sqrt(torch.sum(g * g, dim=-1)),
        steps=state.steps + 1)


def normal_draws(gen: torch.Generator, shape, like: torch.Tensor
                 ) -> torch.Tensor:
    """Standard normal draws in like's dtype and on its device, from `gen`
    (a generator on that device): every random number densification uses."""
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def _sample_in_gaussian(gen, quat, scale3):
    """One sample from N(0, R diag(s^2) R^T) per splat: new child positions
    for splits land inside the parent's footprint."""
    n = quat.shape[0]
    eps = normal_draws(gen, (n, 3), scale3) * scale3
    r = rot_from_quat(quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3])
    x = r[0] * eps[:, 0] + r[1] * eps[:, 1] + r[2] * eps[:, 2]
    y = r[3] * eps[:, 0] + r[4] * eps[:, 1] + r[5] * eps[:, 2]
    z = r[6] * eps[:, 0] + r[7] * eps[:, 1] + r[8] * eps[:, 2]
    return torch.stack([x, y, z], dim=-1)


@torch.no_grad()
def densify_step(params: Dict[str, torch.Tensor], state: DensifyState,
                 gen: torch.Generator,
                 cfg: DensifyConfig = DensifyConfig()
                 ) -> Tuple[Dict[str, torch.Tensor], DensifyState,
                            Dict[str, torch.Tensor]]:
    """One densify / prune event. Writes the new parameters into `params`'
    tensors in place and returns (params, reset_state, info); info holds
    0-d counts (n_pruned, n_placed, n_split, n_cloned) and the (N,) bool
    `changed`: the slots whose contents changed identity (pruned, refilled
    or split parents). Everything else keeps its parameters bit for bit."""
    pos4 = params["position4"]
    n, dtype = pos4.shape[0], pos4.dtype
    avg_grad = state.grad_accum / torch.clamp(state.steps, min=1).to(dtype)

    alive = params["color"][:, 3] > cfg.prune_alpha
    prune = ~alive
    max_scale = torch.amax(torch.abs(params["scale3"]), dim=-1)
    candidate = alive & (avg_grad > cfg.grad_thresh)
    do_split = candidate & (max_scale > cfg.split_scale)

    # Rank freed slots (pruned first, stable) and candidates (best first):
    # the k-th best candidate fills the k-th freed slot.
    slot = torch.argsort(torch.where(prune, 0, 1), stable=True)
    src = torch.argsort(torch.where(candidate, -avg_grad, torch.inf),
                        stable=True)
    pair_valid = prune[slot] & candidate[src]

    # Child parameters gathered from the sources, before any update.
    child = {f: a[src] for f, a in params.items()}
    split_src = do_split[src]
    shrink = torch.where(split_src, 1.0 / cfg.split_factor, 1.0)[:, None]
    offset = _sample_in_gaussian(gen, child["quat"], child["scale3"])
    child_pos3 = child["position4"][:, :3] + torch.where(
        split_src[:, None], offset, torch.zeros_like(offset))
    child["position4"] = torch.cat([child_pos3, child["position4"][:, 3:]],
                                   dim=-1)
    child["scale3"] = child["scale3"] * shrink

    # Silence pruned splats (alpha 0), shrink split parents, then scatter
    # the children into their slots.
    params["color"][:, 3] *= alive.to(dtype)
    params["scale3"] *= torch.where(do_split, 1.0 / cfg.split_factor,
                                    1.0)[:, None]
    for f, cur in params.items():
        mask = pair_valid.reshape((n,) + (1,) * (cur.ndim - 1))
        cur.index_copy_(0, slot, torch.where(mask, child[f], cur[slot]))

    changed = prune | do_split
    changed = changed.index_copy(0, slot, changed[slot] | pair_valid)
    info = dict(n_pruned=prune.sum(), n_placed=pair_valid.sum(),
                n_split=(pair_valid & split_src).sum(),
                n_cloned=(pair_valid & ~split_src).sum(), changed=changed)
    return params, init_state(n, dtype, pos4.device), info


@torch.no_grad()
def reset_opt_slots(optimizer: torch.optim.Optimizer, changed: torch.Tensor,
                    n: int) -> torch.optim.Optimizer:
    """Zero the optimizer's per-slot state (Adam's exp_avg and exp_avg_sq)
    at `changed` slots only, in place: every state tensor whose leading
    axis is the capacity n is masked; the step count (0-d) is kept, so
    untouched slots keep their momentum and bias correction."""
    for st in optimizer.state.values():
        for leaf in st.values():
            if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 1
                    and leaf.shape[0] == n):
                keep = (~changed).reshape((n,) + (1,) * (leaf.ndim - 1))
                leaf.mul_(keep.to(leaf.dtype))
    return optimizer


def pad_params(params: Dict[str, torch.Tensor], capacity: int
               ) -> Dict[str, torch.Tensor]:
    """Grow the dict to `capacity` slots; new slots are dead (alpha 0,
    benign geometry). Returns new tensors (the shapes change), so run it
    before a fit, not inside one."""
    n = params["position4"].shape[0]
    extra = capacity - n
    if extra <= 0:
        return params
    out = {}
    for f, a in params.items():
        pad = a.new_zeros((extra,) + a.shape[1:])
        if f == "scale3":
            pad = pad + 1e-3
        elif f == "lifetime":
            pad = pad + 1.0
        elif f == "fade":
            pad = pad + 0.5
        elif f == "quat":
            pad[:, 0] = 1.0
        out[f] = torch.cat([a.detach(), pad], dim=0)
    return out


def alive_count(params: Dict[str, torch.Tensor],
                prune_alpha: float = 5e-3) -> torch.Tensor:
    """Number of live splats, as a 0-d tensor (no host read)."""
    return torch.sum(params["color"][:, 3] > prune_alpha)
