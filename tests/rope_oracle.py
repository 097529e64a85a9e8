"""The RoPE table's definition, evaluated independently of the host and of
JAX (the card's tests import it on a machine without JAX).

fp32 frequencies ``1 / 10000 ** (2i / D)`` taken in Python float64 and
rounded once (numpy's own fp32 ``power`` picks its code path by the CPU
features it finds at run time, so its last bit moves between hosts), fp32
angles (correctly rounded products), cos and sin in fp64.
"""

import numpy as np


def rope_table_fp64(head_dim, positions=16384):
    """``(table [P, 2, D] fp64, each frequency's fp32 ulp, fp32 angles)``."""
    freqs = np.array([1.0 / 10000.0 ** (i / head_dim) for i in range(0, head_dim, 2)],
                     dtype=np.float64).astype(np.float32)
    angles = np.arange(positions, dtype=np.float32)[:, None] * freqs  # fp32 products
    cos, sin = np.cos(angles.astype(np.float64)), np.sin(angles.astype(np.float64))
    table = np.stack([np.repeat(cos, 2, -1), np.stack([-sin, sin], -1).reshape(positions, -1)], 1)
    return table, np.spacing(freqs), angles
