"""Training launcher: end-to-end fault-tolerant training on any arch config.

On the card (the default):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --reduced \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir build/train/run1

On the CPU, asked for by name:

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --reduced \\
      --steps 20 --batch 2 --seq 16 --device cpu

The coordinator handles checkpoints, preemption (SIGTERM: save, then exit
143) and restarts: a second run on the same ``--ckpt-dir`` resumes from
its latest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.runtime.coordinator import CoordinatorConfig, TrainingCoordinator

__all__ = ["build", "main"]


def _run_device(device) -> torch.device:
    """The card unless the caller names another device; no card raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA device and none is available; "
                           "pass device='cpu' (--device cpu) to train on the CPU")
    return dev


def build(arch: str, reduced: bool, batch: int, seq: int, steps: int, ckpt_dir: str,
          lr: float = 3e-4, seed: int = 0, device=None) -> TrainingCoordinator:
    """A coordinator that trains ``arch`` (its ``reduced()`` config if
    ``reduced``) on ``device`` (default: the card), parameters drawn by
    ``models.model.init_params`` from a ``torch.Generator`` seeded with
    ``seed`` on that device, batches from the seeded pipeline."""
    dev = _run_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    opt_cfg = adamw.AdamWConfig(lr=lr, schedule=linear_warmup_cosine(10, steps))
    step_fn = make_train_step(cfg, opt_cfg)

    def init_state(device=None):
        at = torch.device(device) if device is not None else dev
        gen = None if at.type == "meta" else torch.Generator(device=at).manual_seed(seed)
        params = model.init_params(cfg, gen, device=at)[0].stage(None)
        return {"params": params, "opt_state": adamw.init_state(opt_cfg, params)}

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=seq,
        global_batch=batch,
        num_codebooks=cfg.num_codebooks,
        seed=seed,
    )
    return TrainingCoordinator(
        train_step=step_fn,
        init_state=init_state,
        data_cfg=data_cfg,
        ckpt=CheckpointManager(ckpt_dir, keep=3),
        cfg=CoordinatorConfig(checkpoint_every=max(steps // 4, 1), max_steps=steps),
        device=dev,
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fail-at", type=int, default=None, help="inject crash (test)")
    args = ap.parse_args(argv)

    coord = build(
        args.arch, args.reduced, args.batch, args.seq, args.steps, args.ckpt_dir,
        lr=args.lr, device=args.device,
    )
    coord.install_preemption_handler()
    step, _ = coord.run(steps=args.steps, fail_at_step=args.fail_at)
    first, last = coord.metrics_log[0], coord.metrics_log[-1]
    print(json.dumps({
        "arch": args.arch,
        "device": str(coord.device),
        "steps_run": len(coord.metrics_log),
        "final_step": step,
        "loss_first": first["loss"],
        "loss_last": last["loss"],
        "improved": last["loss"] < first["loss"],
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
