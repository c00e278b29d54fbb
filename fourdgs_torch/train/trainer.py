"""Single-device training loop for fitting 4D splat scenes to images (port of
fourdgs/train/trainer.py).

`fit` cycles through (target image, t) frames with Adam
(`torch.optim.Adam`: b1 0.9, b2 0.999, eps 1e-8, as `optax.adam`), rendering
through `materialize_splats` and `render_splats4d`, with optional adaptive
density control (train/densify.py). The step is eager: it reads the loss
back to the host once (as the reference's `float(loss)`), and densify
counts only at an event that is logged or printed.

Checkpoints are the reference's npz form (`trainer.py:180-190`): one array a
field plus `__step__`. The reference writes an orbax directory when it can
import orbax; this package reads and writes npz only and names the form it
wants when handed such a directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from fourdgs_torch import resolve_device
from fourdgs_torch.core.camera import Camera
from fourdgs_torch.parallel.distributed import materialize_splats
from fourdgs_torch.render.pipeline import RenderConfig, render_splats4d
from fourdgs_torch.train import densify as D
from fourdgs_torch.train import loss as L


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: List[float]


class MetricsLogger:
    """Structured training metrics: one JSON object per event appended to a
    JSONL file (and optionally echoed), the reference's line format."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "wall_s": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "dtype") or
                      isinstance(v, (int, float)) else v)
                  for k, v in fields.items()}}
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def make_loss_fn(camera: Camera, cfg: RenderConfig, min_opacity=0.0,
                 ssim_weight: float = 0.0) -> Callable:
    def loss_fn(params, target, t):
        splats = materialize_splats(params)
        img = render_splats4d(splats, camera, t, min_opacity, cfg=cfg)
        if ssim_weight > 0:
            return L.photometric(img, target, ssim_weight)
        return L.l2(img, target)
    return loss_fn


def _adam(params: Dict[str, torch.Tensor], learning_rate: float):
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def fit(params: Dict[str, torch.Tensor],
        frames: Iterable[Tuple[torch.Tensor, float]],
        camera: Camera,
        steps: int = 200,
        learning_rate: float = 5e-3,
        cfg: RenderConfig = RenderConfig(),
        ssim_weight: float = 0.0,
        log_every: int = 0,
        densify_cfg: Optional[D.DensifyConfig] = None,
        densify_every: int = 50,
        densify_until: float = 0.7,
        seed: int = 0,
        metrics: Optional[MetricsLogger] = None) -> FitResult:
    """Fit splat parameters (the trainer's dict, parallel/distributed.py
    PARAM_FIELDS, on the camera's device) to (target_image, t) frames by
    cycling through them with Adam. The caller's tensors are not changed:
    the fit trains copies and returns them.

    With `densify_cfg`, positional-gradient norms accumulate every step and
    every `densify_every` steps (until `densify_until * steps`) low-opacity
    splats are pruned and their slots refilled with clones / splits of the
    highest-pressure splats (capacity is static: pad with
    densify.pad_params beforehand). At each event the optimizer follows
    DensifyConfig.opt_reset: "slots" zeroes Adam's moments at the changed
    slots and keeps the step count; "all" makes a new optimizer, step 0.
    The split offsets are drawn from a torch.Generator seeded with `seed`."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    device = params["position4"].device
    # Frame times as 0-d tensors on the device, made once: no host sync in
    # the step (packed.time_like).
    frames = [(target, float(t), torch.tensor(float(t), device=device))
              for target, t in frames]
    loss_fn = make_loss_fn(camera, cfg, ssim_weight=ssim_weight)
    opt = _adam(params, learning_rate)

    n = params["position4"].shape[0]
    dstate = gen = None
    if densify_cfg is not None:
        dstate = D.init_state(n, params["position4"].dtype, device)
        gen = torch.Generator(device=device).manual_seed(seed)

    losses = []
    for i in range(steps):
        target, t, t_dev = frames[i % len(frames)]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, target, t_dev)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if metrics is not None and (log_every == 0 or i % log_every == 0):
            metrics.log("train_step", step=i, loss=losses[-1], t=t)
        if densify_cfg is not None:
            dstate = D.accumulate(dstate,
                                  {k: p.grad for k, p in params.items()})
            if (i + 1) % densify_every == 0 and i + 1 < densify_until * steps:
                params, dstate, info = D.densify_step(params, dstate, gen,
                                                      densify_cfg)
                if densify_cfg.opt_reset == "all":
                    opt = _adam(params, learning_rate)
                else:
                    D.reset_opt_slots(opt, info["changed"], n)
                if metrics is not None or log_every:
                    counts = {k: int(info[k]) for k in
                              ("n_pruned", "n_placed", "n_split")}
                    if metrics is not None:
                        metrics.log("densify", step=i, **counts)
                    if log_every:
                        print(f"step {i}: densify pruned={counts['n_pruned']}"
                              f" placed={counts['n_placed']} "
                              f"split={counts['n_split']}")
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return FitResult(params={k: v.detach() for k, v in params.items()},
                     losses=losses)


# ---------------------------------------------------------------------------
# checkpointing: the reference's npz form
# ---------------------------------------------------------------------------

def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    step: Optional[int] = None) -> None:
    """Save a parameter dict as `path`(.npz): one array a field and
    `__step__` (-1 without a step), the reference's npz form."""
    np.savez(_npz_path(path),
             **{k: v.detach().cpu().numpy() for k, v in params.items()},
             __step__=np.asarray(-1 if step is None else step))


def load_checkpoint(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Load a checkpoint of the npz form into tensors on `device` (None:
    the card, fourdgs_torch.default_device). Raises ValueError for an orbax
    checkpoint directory (the reference's other form), FileNotFoundError
    where neither exists."""
    npz = _npz_path(path)
    if os.path.exists(npz):
        device = resolve_device(device)
        with np.load(npz) as data:
            return {k: torch.from_numpy(data[k]).to(device) for k in data.files
                    if not k.startswith("__")}
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint?): "
                         f"this package reads the npz form only, {npz}")
    raise FileNotFoundError(npz)
