"""The result line, the device's description, and the checks every run
makes of itself."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Optional

# Top-level module names the benchmark's process must not hold: JAX and the
# JAX package the port was made from. Compared whole: "fourdgs_torch" is not
# "fourdgs".
FORBIDDEN = ("jax", "jaxlib", "flax", "fourdgs")


def forbidden_modules(modules=None) -> List[str]:
    """The FORBIDDEN top-level names among `modules` (sys.modules)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def card(index: int = 0) -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        name, limit = [x.strip() for x in out.strip().split(",", 1)]
        return dict(smi_name=name, power_limit=limit)
    except (OSError, subprocess.SubprocessError, ValueError):
        return dict(smi_name=None, power_limit=None)


def device_block(torch, count: int, memory_peak_bytes: int,
                 busy_s: Optional[float] = None,
                 window_s: Optional[float] = None) -> dict:
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=count, memory_peak_bytes=int(memory_peak_bytes))
    if busy_s is not None:
        dev.update(busy_s=busy_s, window_s=window_s)
    return dev


def checks_ok(checks: Dict[str, dict]) -> bool:
    """Every compared number within its limit (a missing number fails)."""
    return bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())


def print_checks(checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: Dict[str, dict],
           extra: Optional[dict] = None) -> dict:
    """The result object (a dict keeps its order): correct, attempted,
    failed, metrics, device, then `extra`, and the checks last."""
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=device)
    out.update(extra or {})
    out["checks"] = checks
    return out
