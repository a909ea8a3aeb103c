"""Layered YAML/JSON config system with auto-generated CLI flags.

Behavioral parity with the reference config stack (see SURVEY.md §5.6;
reference: utils/exp_util.py:12-112):
  * YAML files may contain an ``include_configs`` key naming a base file
    (relative to the including file) whose keys are inherited and overridden.
  * JSON configs may be a dict or a list of dicts; keys named ``"_"`` are
    comments; lenient fixing converts Python literals (None/True/False/') to
    JSON before parsing.
  * ``ArgumentParserX`` takes a positional config path and auto-registers
    every config key as a typed ``--key`` override, plus ``--exec`` which
    executes arbitrary attribute mutations on the parsed namespace.
  * ``dict_to_args`` wraps nested dict configs as attribute namespaces.

The same YAML files shipped with the reference parse unchanged.
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

import numpy as np
import yaml


def parse_config_json(json_path: Path, args: argparse.Namespace = None):
    """Parse a (possibly comment-carrying, Python-literal-laced) JSON config."""
    if args is None:
        args = argparse.Namespace()
    json_path = Path(json_path)
    text = json_path.read_text()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError:
        text = (
            text.replace("'", '"')
            .replace("None", "null")
            .replace("False", "false")
            .replace("True", "true")
        )
        raw = json.loads(text)
    if isinstance(raw, dict):
        raw = [raw]
    for chunk in raw:
        for key, value in chunk.items():
            if key != "_":
                setattr(args, key, value)
    return args


def parse_config_yaml(yaml_path: Path, args: argparse.Namespace = None, override: bool = True):
    """Parse a YAML config with recursive ``include_configs`` inheritance."""
    if args is None:
        args = argparse.Namespace()
    yaml_path = Path(yaml_path)
    with yaml_path.open() as f:
        configs = yaml.safe_load(f)
    if configs is not None:
        if "include_configs" in configs:
            base_rel = configs.pop("include_configs")
            base_path = yaml_path.parent / Path(base_rel)
            with base_path.open() as f:
                base = yaml.safe_load(f)
            base.update(configs)
            configs = base
        for key, value in configs.items():
            if override or key not in args.__dict__:
                setattr(args, key, value)
    return args


def dict_to_args(data: dict) -> argparse.Namespace:
    args = argparse.Namespace()
    for key, value in data.items():
        setattr(args, key, value)
    return args


class ArgumentParserX(argparse.ArgumentParser):
    """Parser with a positional config file whose keys become CLI flags."""

    def __init__(self, base_config_path=None, add_hyper_arg=True, **kwargs):
        super().__init__(**kwargs)
        self.add_hyper_arg = add_hyper_arg
        self.base_config_path = base_config_path
        if self.add_hyper_arg:
            self.add_argument("hyper", type=str, help="Path to the yaml/json config")
        self.add_argument("--exec", type=str, help="Python statements mutating the parsed args")

    def parse_args(self, args=None, namespace=None):
        _args = self.parse_known_args(args, namespace)[0]
        file_args = argparse.Namespace()
        if self.base_config_path is not None:
            file_args = parse_config_yaml(Path(self.base_config_path), file_args)
        if self.add_hyper_arg:
            if str(_args.hyper).endswith("json"):
                file_args = parse_config_json(Path(_args.hyper), file_args)
            else:
                file_args = parse_config_yaml(Path(_args.hyper), file_args)
            for key, value in file_args.__dict__.items():
                try:
                    self.add_argument("--" + key, type=type(value), default=value, required=False)
                except argparse.ArgumentError:
                    continue
        _args = super().parse_args(args, namespace)
        if _args.exec is not None:
            for cmd in _args.exec.split(";"):
                exec("_args." + cmd.strip())  # noqa: S102 - explicit user-requested override hook
        return _args


def init_seed(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed)
