"""Backbone registry (the JAX package's ``models/registry.py``): routing by
architecture, ``ssm_cfg`` empty -> transformer. The hybrid backbone is not
ported yet: ``TransformerBackbone`` refuses a hybrid config."""

from __future__ import annotations

from ..config import BackboneConfig
from .backbone import TransformerBackbone


def backbone_for_config(cfg: BackboneConfig):
    return TransformerBackbone(cfg)
