"""Single-device training loop for fitting 4D splat scenes to images (port of
fourdgs/train/trainer.py).

`Fitter` is one fitting job taken a step at a time: it owns the trainable
copies of the parameters, Adam (`torch.optim.Adam`: b1 0.9, b2 0.999, eps
1e-8, as `optax.adam`), the densify state and generator, and the step
count. `Fitter.step(target, t, camera)` renders through
`materialize_splats` and `render_splats4d`, takes the loss, its backward,
Adam's step and, with adaptive density control (train/densify.py), the
gradient statistics and a densify event when one is due; it returns the
loss as a 0-d tensor on the device and reads nothing back to the host.
`fit` is the closed loop over `Fitter.step` that reads each step's loss
back once (as the reference's `float(loss)`); densify counts are read only
at an event that is logged or printed.

A step is traced under `fourdgs::fit_step`, and inside it, one after the
other, `fourdgs::optimizer` (zero_grad), `fourdgs::forward` (the
materialization, the render's `fourdgs::frame` and `fourdgs::loss`),
`fourdgs::backward`, `fourdgs::optimizer` (Adam) and `fourdgs::densify`.
On a CUDA device autograd runs the backward on its own thread while the
calling thread waits inside `fourdgs::backward`, so the backward's
launches fall within that range's span on the host's clock.

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
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from fourdgs_torch import resolve_device
from fourdgs_torch.core.camera import Camera
from fourdgs_torch.parallel.distributed import materialize_splats
from fourdgs_torch.render.pipeline import RenderConfig, render_splats4d
from fourdgs_torch.train import densify as D
from fourdgs_torch.train import loss as L

# The range around each training step: one a step, never nested.
STEP = "fourdgs::fit_step"


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


def _objective(img: torch.Tensor, target: torch.Tensor,
               ssim_weight: float) -> torch.Tensor:
    if ssim_weight > 0:
        return L.photometric(img, target, ssim_weight)
    return L.l2(img, target)


def make_loss_fn(camera: Camera, cfg: RenderConfig, min_opacity=0.0,
                 ssim_weight: float = 0.0) -> Callable:
    def loss_fn(params, target, t):
        splats = materialize_splats(params)
        img = render_splats4d(splats, camera, t, min_opacity, cfg=cfg)
        return _objective(img, target, ssim_weight)
    return loss_fn


def _adam(params: Dict[str, torch.Tensor], learning_rate: float):
    return torch.optim.Adam(list(params.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


# The render's loss counters: a step where one is not 0 lost pairs (over the
# budget, dropped by the compaction) or left transmittance behind a
# truncated tile.
LOSS_COUNTERS = ("overflowed", "compact_dropped", "resid_transmittance")


class Fitter:
    """One fitting job, a step at a time (see the module docstring).

    `params` is the trainer's dict (parallel/distributed.py PARAM_FIELDS);
    the caller's tensors are not changed: the fitter trains copies,
    `self.params`. `camera` is the camera of a step given none.

    With `densify_cfg`, positional-gradient norms accumulate every step and
    after every `densify_every`-th step (steps counted from 1, while the
    count is below `densify_until`; None: no end) low-opacity splats are
    pruned and their slots refilled with clones / splits of the
    highest-pressure splats (capacity is static: pad with
    densify.pad_params beforehand). At each event the optimizer follows
    DensifyConfig.opt_reset: "slots" zeroes Adam's moments at the changed
    slots and keeps the step count; "all" makes a new optimizer, step 0.
    The split offsets are drawn from a torch.Generator seeded with `seed`.

    `lossy` counts, on the device, the steps whose render lost pairs (a
    LOSS_COUNTERS entry not 0); `aux` is the last step's render counters
    (0-d tensors) and `last_event` the densify info of its event, or
    None."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 camera: Optional[Camera] = None,
                 learning_rate: float = 5e-3,
                 cfg: RenderConfig = RenderConfig(),
                 ssim_weight: float = 0.0,
                 densify_cfg: Optional[D.DensifyConfig] = None,
                 densify_every: int = 50,
                 densify_until: Optional[float] = None,
                 seed: int = 0):
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.device = self.params["position4"].device
        self.camera, self.cfg = camera, cfg
        self.learning_rate, self.ssim_weight = learning_rate, ssim_weight
        self.opt = _adam(self.params, learning_rate)
        self.n = self.params["position4"].shape[0]
        self.densify_cfg = densify_cfg
        self.densify_every, self.densify_until = densify_every, densify_until
        self.dstate = self.gen = None
        if densify_cfg is not None:
            self.dstate = D.init_state(self.n, self.params["position4"].dtype,
                                       self.device)
            self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps_done = 0
        self.lossy = torch.zeros((), dtype=torch.int32, device=self.device)
        self.aux = {}
        self.last_event = None

    def densify_due(self, i: Optional[int] = None) -> bool:
        """Whether step i (0-based; default the next) ends in a densify
        event."""
        i = self.steps_done if i is None else i
        return (self.densify_cfg is not None
                and (i + 1) % self.densify_every == 0
                and (self.densify_until is None
                     or i + 1 < self.densify_until))

    def step(self, target: torch.Tensor, t,
             camera: Optional[Camera] = None) -> torch.Tensor:
        """One training step toward `target` (H, W, >=3) at time t (a float
        or a 0-d tensor on the device) seen from `camera` (default: the
        fitter's). Returns the loss, a 0-d tensor on the device."""
        camera = self.camera if camera is None else camera
        event = self.densify_due()
        with record_function(STEP):
            with record_function("fourdgs::optimizer"):
                self.opt.zero_grad(set_to_none=True)
            with record_function("fourdgs::forward"):
                splats = materialize_splats(self.params)
                img, aux = render_splats4d(splats, camera, t, cfg=self.cfg,
                                           return_aux=True)
                with record_function("fourdgs::loss"):
                    loss = _objective(img, target, self.ssim_weight)
                self.aux = aux
                self.lossy += torch.stack([aux[k] != 0 for k in LOSS_COUNTERS
                                           if k in aux]).any()
            with record_function("fourdgs::backward"):
                loss.backward()
            with record_function("fourdgs::optimizer"):
                self.opt.step()
            self.last_event = None
            if self.densify_cfg is not None:
                with record_function("fourdgs::densify"):
                    self._densify(event)
            self.steps_done += 1
            return loss.detach()

    def _densify(self, event: bool) -> None:
        self.dstate = D.accumulate(self.dstate, {k: p.grad for k, p in
                                                 self.params.items()})
        if not event:
            return
        self.params, self.dstate, info = D.densify_step(
            self.params, self.dstate, self.gen, self.densify_cfg)
        if self.densify_cfg.opt_reset == "all":
            self.opt = _adam(self.params, self.learning_rate)
        else:
            D.reset_opt_slots(self.opt, info["changed"], self.n)
        self.last_event = info


def fit(params: Dict[str, torch.Tensor],
        frames: Iterable[tuple],
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
    PARAM_FIELDS, on the camera's device) to frames by cycling through them
    with a `Fitter`. A frame is (target_image, t), seen from `camera`, or
    (target_image, t, its own camera). The caller's tensors are not
    changed: the fit trains copies and returns them.

    With `densify_cfg`, a densify event follows every `densify_every`-th
    step until `densify_until * steps` (Fitter documents the rest)."""
    fitter = Fitter(params, camera, learning_rate, cfg, ssim_weight,
                    densify_cfg, densify_every, densify_until * steps, seed)
    # Frame times as 0-d tensors on the device, made once: no host sync in
    # the step (packed.time_like).
    frames = [(f[0], float(f[1]),
               torch.tensor(float(f[1]), device=fitter.device),
               f[2] if len(f) > 2 else camera) for f in frames]
    losses = []
    for i in range(steps):
        target, t, t_dev, cam = frames[i % len(frames)]
        losses.append(fitter.step(target, t_dev, cam).item())
        if metrics is not None and (log_every == 0 or i % log_every == 0):
            metrics.log("train_step", step=i, loss=losses[-1], t=t)
        info = fitter.last_event
        if info is not None and (metrics is not None or log_every):
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
    return FitResult(params={k: v.detach() for k, v in fitter.params.items()},
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
