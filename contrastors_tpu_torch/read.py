"""YAML -> Config loader, counterpart of `contrastors_tpu/read.py`.

PyYAML is imported when a file is read, not with the module."""

from pathlib import Path
from typing import Union

from contrastors_tpu_torch.config import Config


def read_config(path: Union[str, Path]) -> Config:
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    # some recipes name the data block "contrastive_data_args"; it is an
    # alias of data_args
    if "contrastive_data_args" in raw and "data_args" not in raw:
        raw["data_args"] = raw.pop("contrastive_data_args")
    return Config.from_dict(raw)
