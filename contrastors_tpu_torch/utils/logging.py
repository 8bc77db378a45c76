"""Metrics logging, counterpart of `contrastors_tpu/utils/logging.py`:
metrics.jsonl lines ({"step", "t", metrics...}) in output_dir, a printed
line every `print_every` steps, and wandb when enabled (imported only
then). Tensor values are read here, at log time, in one stacked copy to
the host, so the loop syncs with the device only on its log steps."""

import json
import os
import time
from typing import Any, Dict, Optional

import torch


def to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Every scalar tensor of metrics as a Python float, fetched in one
    device-to-host copy per device; other values as float where they
    convert, else as they are."""
    out = dict(metrics)
    by_device: Dict[torch.device, list] = {}
    for k, v in metrics.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(k)
    for keys in by_device.values():
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu().tolist()
        out.update(zip(keys, values))
    for k, v in out.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            pass
    return out


class Tracker:
    def __init__(
        self,
        enabled_wandb: bool = False,
        project: Optional[str] = None,
        entity: Optional[str] = None,
        run_name: Optional[str] = None,
        group: Optional[str] = None,
        output_dir: Optional[str] = None,
        hyperparams: Optional[Dict[str, Any]] = None,
        print_every: int = 10,
    ):
        self.print_every = print_every
        self._wandb = None
        self._jsonl = None
        if enabled_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, entity=entity, name=run_name, group=group,
                                         config=hyperparams)
            except Exception as e:  # noqa: BLE001 - no wandb or no network: jsonl only
                print(f"[tracker] wandb unavailable ({e}); logging to jsonl")
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    def log(self, metrics: Dict[str, Any], step: int):
        payload = to_host(metrics)
        if self._wandb is not None:
            self._wandb.log(payload, step=step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "t": time.time() - self._t0, **payload}) + "\n")
            self._jsonl.flush()
        if step % self.print_every == 0:
            brief = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in payload.items())
            print(f"[step {step}] {brief}", flush=True)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
