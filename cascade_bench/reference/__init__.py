"""The plain reference. One module per model family, ``<family>.py``,
named by a configuration's ``family`` key: its widths, the keys it
implements, the weight layout it reads, its forward pass and its model
FLOPs. Beside them the local tier (``surrogate.py``) and the two
supervisors (``supervisors.py``). Nothing here imports the program.

A new family is a new file here that defines what ``dense.py`` does.
"""

from __future__ import annotations

import contextlib
import importlib
import re

import torch

FAMILY = re.compile(r"[a-z][a-z0-9_]{0,31}")


def family(config: dict):
    """The family module of ``config`` (a ``configs/*.json`` dict), once
    it has accepted every key of the configuration."""
    name = config.get("family")
    if not isinstance(name, str) or not FAMILY.fullmatch(name):
        raise ValueError(f"{config.get('name')!r}: no family key")
    mod = importlib.import_module(f"{__name__}.{name}")
    mod.accept(config)
    return mod


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for the duration."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
