"""Shared pieces of the benchmark's own tests: a tiny cell (the flagship
configuration's conditioners and the cell's traffic at toy widths and
lengths) that the whole harness can run on the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_spec(cell: str = "tfm-int8.pool8-narration", **mix) -> dict:
    """The cell's spec with toy widths and lengths."""
    from perfbench import run as R

    spec = copy.deepcopy(R.load_cell(cell))
    cfg = spec["config"]
    bb = cfg["model"]["backbone"]
    if bb.get("ssm_cfg"):
        bb.update(d_model=64, n_layer=3, attn_layer_idx=[1],
                  ssm_cfg={"layer": "Mamba2", "d_state": 16, "headdim": 16, "chunk_size": 16},
                  attn_cfg={"num_heads": 4, "num_heads_kv": 2, "rotary_emb_dim": 8})
    else:
        bb.update(d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                  attn_cfg={"num_heads": 4, "num_heads_kv": 2})
    bb["attn_mlp_d_intermediate"] = 128
    cfg["dac"]["decoder_hidden_size"] = 64
    cfg["speaker"] = {"in_planes": 8, "depths": [2, 2, 2, 2], "embd_dim": 32,
                      "acoustic_dim": 80, "lda_dim": 128}
    # The toy model's own limit: its sound runs on the CPU read gaps of
    # about 0.03 (bf16 activations), its planted faults 0.15 and more.
    cfg["limits"] = dict(cfg["limits"], logit_gap=0.08)
    m = spec["mix"]
    m.update(seconds={"min": 0.5, "max": 1.0}, lead_in_s=1.0, grace_s=20.0, check={"requests": 3})
    if m["server"]["pooled"]:
        m["server"] = {"pooled": True, "pool_slots": 2}
    if m["loop"] == "closed" and m["clients"] > 1:
        m["clients"] = 3
    m.update(mix)
    return spec


@pytest.fixture
def cuda():
    """Skips the test without a CUDA device (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
