"""Config file IO (copy of :mod:`pointgnn_tpu.utils.config_io`).

A "config" file holds the model/graph/encoding selection, a
"train_config" file the run hyperparameters, both as JSON.  A built-in
configuration name (:func:`pointgnn_tpu_torch.configs.list_configs`) is
accepted anywhere a path is expected.
"""

import json
import os

from pointgnn_tpu_torch import configs as builtin


def load_config(path_or_name: str) -> dict:
    if os.path.isfile(path_or_name):
        with open(path_or_name) as f:
            return json.load(f)
    name = os.path.basename(path_or_name).replace("_config", "")
    if name in builtin.list_configs():
        return builtin.get_config(name)
    raise FileNotFoundError(path_or_name)


def save_config(path: str, config: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f, indent=4, sort_keys=True)


def load_train_config(path_or_name: str) -> dict:
    if os.path.isfile(path_or_name):
        with open(path_or_name) as f:
            return json.load(f)
    name = os.path.basename(path_or_name).replace("_train_config", "")
    if name in builtin.list_configs():
        return builtin.get_train_config(name)
    raise FileNotFoundError(path_or_name)


def save_train_config(path: str, config: dict) -> None:
    save_config(path, config)
