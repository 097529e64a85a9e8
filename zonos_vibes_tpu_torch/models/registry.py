"""Backbone registry (the JAX package's ``models/registry.py``): routing by
architecture, ``ssm_cfg`` empty -> transformer, else hybrid."""

from __future__ import annotations

from ..config import BackboneConfig
from .backbone import TransformerBackbone
from .mamba_backbone import HybridBackbone


def backbone_for_config(cfg: BackboneConfig):
    return (HybridBackbone if cfg.is_hybrid else TransformerBackbone)(cfg)
