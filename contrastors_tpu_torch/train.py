"""CLI launcher, counterpart of `contrastors_tpu/train.py`.

    python -m contrastors_tpu_torch.train --config=configs/train/X.yaml \
        [--dtype=bf16] [--device=cuda] [--key=value overrides]

Trains on the card by default, which must be present; `--device cpu` runs
the plain PyTorch path. On several cards, launch one process per card as
the reference does:

    torchrun --nproc-per-node=N -m contrastors_tpu_torch.train --config=...

Each rank joins the process group before its trainer is built
(`utils/dist.py:maybe_initialize_distributed`, JAX's `train.py:55-60`),
with NCCL on the cards ($CONTRASTORS_DIST_BACKEND=gloo for gloo, which is
the CPU's backend), and `--device cuda` means the rank's own card,
`cuda:LOCAL_RANK`. The config's `parallel_args: {data: d, expert: e,
tensor: t}` lays the N ranks out as JAX's mesh (d * e * t = N, data -1 for
N / (e * t)): the data axis splits the batch, the expert axis the MoE
experts and the tensor axis the attention heads and MLP columns
(`parallel/mesh.py`, `parallel/sharding.py`).
"""

import argparse
from typing import Optional

from contrastors_tpu_torch.config import Config
from contrastors_tpu_torch.read import read_config
from contrastors_tpu_torch.trainers import TRAINER_REGISTRY
from contrastors_tpu_torch.utils.dist import maybe_initialize_distributed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="contrastors_tpu_torch trainer")
    parser.add_argument("--config", required=True)
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--device", default="cuda", help="cuda (default; a rank's own card) or cpu")
    parser.add_argument("--learning_rate", type=float)
    parser.add_argument("--batch_size", type=int)
    parser.add_argument("--num_epochs", type=int)
    parser.add_argument("--num_train_steps", type=int)
    parser.add_argument("--output_dir")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--wandb", action="store_true", default=None)
    return parser.parse_args(argv)


def update_config_with_args(config: Config, args) -> Config:
    """CLI flags override the matching field of every arg group that has it,
    the per-tower groups included."""
    groups = (
        config.train_args,
        config.data_args,
        config.text_data_args,
        config.model_args,
        config.text_model_args,
        config.vision_model_args,
        config.tower_model_args,
    )
    for group in groups:
        if group is None:
            continue
        for key, value in vars(args).items():
            if value is not None and hasattr(group, key):
                setattr(group, key, value)
    return config


def run(config: Config, dtype: str = "bf16", device="cuda", trainer_cls: Optional[type] = None):
    """Build the config's trainer (trainer_cls, else the registry's for its
    model_type), train it, and return it."""
    margs = config.model_args or config.text_model_args
    if margs is None:
        raise SystemExit(
            "neither model_args nor text_model_args is set: check the config's top-level keys "
            "(unknown keys are ignored, so a typo like 'model_arg:' disappears)"
        )
    trainer = (trainer_cls or TRAINER_REGISTRY[margs.model_type])(config, dtype, device)
    trainer.train()
    return trainer


def main(argv=None):
    args = parse_args(argv)
    config = update_config_with_args(read_config(args.config), args)
    device = args.device
    if maybe_initialize_distributed(device=None if device == "cuda" else device):
        import torch

        if device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
    return run(config, args.dtype, device)


if __name__ == "__main__":
    main()
