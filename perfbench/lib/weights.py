"""Every weight a cell serves, made by the benchmark from ``--seed``.

The weights are the benchmark's inputs: the program and the plain reference
are handed the same tensors, and the reference derives on its own whatever
the program derives from them (int8 scales, folded layouts, caches). The
trees follow the parameter layout of the port's checkpoint cache (the JAX
package's tree: linear weights ``[in, out]``, layers stacked on a leading
axis, the hybrid's layers stacked by kind), which ``ZonosPipeline.from_params``
takes as it is.

Values are drawn on the device in two calls, one per dtype (a bf16 and an
fp32 normal stream of every leaf's elements end to end), and cut into
leaves; norms start at one, biases small. Scales follow the usual
initialisations (normal over sqrt(fan-in)); the Mamba-2 ``A`` and ``dt``
follow Mamba-2's own ranges, so the state remembers over tens of steps.
"""

from __future__ import annotations

import math

import torch

BF16, F32 = torch.bfloat16, torch.float32

# The phoneme table of the Zonos-v0.1 conditioner: PAD, UNK, BOS, EOS and
# 185 symbols (upstream zonos/conditioning.py).
PHONEME_VOCAB = 189


class _Plan:
    """Leaves to draw: ``(path, shape, dtype, init)``; ``init`` is
    ``("normal", std)``, ``("const", value)`` or a named transform of a
    normal draw."""

    def __init__(self):
        self.leaves: list[tuple] = []

    def normal(self, path, shape, std, dtype=BF16):
        self.leaves.append((path, tuple(shape), dtype, ("normal", float(std))))

    def const(self, path, shape, value, dtype=BF16):
        self.leaves.append((path, tuple(shape), dtype, ("const", float(value))))

    def special(self, path, shape, kind, dtype=F32):
        self.leaves.append((path, tuple(shape), dtype, (kind,)))

    def build(self, gen: torch.Generator, device) -> dict:
        drawn = [leaf for leaf in self.leaves if leaf[3][0] != "const"]
        counts = {dt: sum(math.prod(s) for _, s, d, _ in drawn if d == dt) for dt in (BF16, F32)}
        streams = {dt: torch.randn((n,), generator=gen, device=device, dtype=dt)
                   for dt, n in counts.items() if n}
        offsets = {dt: 0 for dt in streams}
        tree: dict = {}
        for path, shape, dtype, init in self.leaves:
            if init[0] == "const":
                t = torch.full(shape, init[1], dtype=dtype, device=device)
            else:
                n = math.prod(shape)
                x = streams[dtype][offsets[dtype]: offsets[dtype] + n].view(shape)
                offsets[dtype] += n
                t = _transform(x, init)
            _put(tree, path, t)
        return tree


def _transform(x: torch.Tensor, init: tuple) -> torch.Tensor:
    kind = init[0]
    if kind == "normal":
        return x * init[1]
    u = torch.special.ndtr(x.float())  # uniform on (0, 1)
    if kind == "A_log":  # A in [1, 16], Mamba-2's range
        return torch.log1p(15.0 * u).to(x.dtype)
    if kind == "dt_bias":  # softplus^-1 of dt log-uniform in [1e-3, 1e-1]
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return (dt + torch.log(-torch.expm1(-dt))).to(x.dtype)
    if kind == "alpha":  # Snake's alpha around one, kept positive
        return (1.0 + 0.1 * x.float()).abs().to(x.dtype)
    raise ValueError(kind)


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        default = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, default)
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def head_width(cfg: dict) -> int:
    """The output heads' padded width (1025 up to a multiple of 128)."""
    n, m = cfg["codebook_size"] + 1, cfg.get("head_pad_to_multiple", 128)
    return n if n % m == 0 else n + m - n % m


def attention_geometry(bb: dict) -> tuple[int, int, int, int]:
    """``(heads, kv heads, head dim, rotary dim)``: the transformer's head
    dim is ``d_model / heads`` with RoPE over all of it; the hybrid's comes
    from ``attn_cfg`` with RoPE over ``rotary_emb_dim``."""
    a = bb.get("attn_cfg") or {}
    hq = a.get("num_heads", 16)
    hkv = a.get("num_heads_kv", max(hq // 4, 1) if not bb.get("ssm_cfg") else hq)
    dh = a.get("head_dim", bb["d_model"] // hq)
    rd = dh if not bb.get("ssm_cfg") else a.get("rotary_emb_dim", dh // 2)
    return hq, hkv, dh, rd


def mamba_geometry(bb: dict) -> dict:
    s = bb["ssm_cfg"]
    d_inner = s.get("expand", 2) * bb["d_model"]
    n = s.get("d_state", 128)
    h = d_inner // s.get("headdim", 64)
    return {"d_inner": d_inner, "d_state": n, "nheads": h, "headdim": s.get("headdim", 64),
            "d_conv": s.get("d_conv", 4), "conv_dim": d_inner + 2 * n,
            "d_in_proj": 2 * d_inner + 2 * n + h}


def _dense(plan, path, n, din, dout):
    plan.normal(path + ("weight",), (n, din, dout), 1.0 / math.sqrt(din))


def _plan_model(plan: _Plan, cfg: dict) -> None:
    bb = cfg["backbone"]
    D, K = bb["d_model"], cfg["num_codebooks"]
    plan.normal(("embeddings", "weight"), (K, cfg["codebook_size"] + 2, D), 1.0)
    plan.normal(("heads", "weight"), (K, D, head_width(cfg)), 1.0 / math.sqrt(D))
    hq, hkv, dh, _ = attention_geometry(bb)
    F = bb["attn_mlp_d_intermediate"]
    if not bb.get("ssm_cfg"):
        L, p = bb["n_layer"], ("backbone", "layers")
        for norm in ("norm1", "in_proj", "out_proj", "norm2", "fc1", "fc2"):
            if norm.startswith("norm"):
                plan.const(p + (norm, "weight"), (L, D), 1.0, F32)
                plan.const(p + (norm, "bias"), (L, D), 0.0, F32)
            elif norm == "in_proj":
                _dense(plan, p + (norm,), L, D, (hq + 2 * hkv) * dh)
            elif norm == "out_proj":
                _dense(plan, p + (norm,), L, hq * dh, D)
            elif norm == "fc1":
                _dense(plan, p + (norm,), L, D, 2 * F)
            else:
                _dense(plan, p + (norm,), L, F, D)
        plan.const(("backbone", "norm_f", "weight"), (D,), 1.0)
        plan.const(("backbone", "norm_f", "bias"), (D,), 0.0)
    else:
        attn = set(bb["attn_layer_idx"])
        La = len(attn)
        M = bb["n_layer"] - La
        g = mamba_geometry(bb)
        p = ("backbone", "mamba")
        plan.const(p + ("norm", "weight"), (M, D), 1.0)
        _dense(plan, p + ("in_proj",), M, D, g["d_in_proj"])
        plan.normal(p + ("conv1d", "weight"), (M, g["d_conv"], g["conv_dim"]), 0.2)
        plan.normal(p + ("conv1d", "bias"), (M, g["conv_dim"]), 0.02)
        plan.special(p + ("dt_bias",), (M, g["nheads"]), "dt_bias")
        plan.special(p + ("A_log",), (M, g["nheads"]), "A_log")
        plan.const(p + ("D",), (M, g["nheads"]), 1.0, F32)
        plan.const(p + ("ssm_norm", "weight"), (M, g["d_inner"]), 1.0)
        _dense(plan, p + ("out_proj",), M, g["d_inner"], D)
        p = ("backbone", "attn")
        plan.const(p + ("norm", "weight"), (La, D), 1.0)
        _dense(plan, p + ("in_proj",), La, D, (hq + 2 * hkv) * dh)
        _dense(plan, p + ("out_proj",), La, hq * dh, D)
        plan.const(p + ("norm2", "weight"), (La, D), 1.0)
        _dense(plan, p + ("fc1",), La, D, 2 * F)
        _dense(plan, p + ("fc2",), La, F, D)
        plan.const(("backbone", "norm_f", "weight"), (D,), 1.0)
    pc = ("prefix_conditioner",)
    for c in cfg["prefix_conditioner"]["conditioners"]:
        name = c.get("name", c["type"])
        base = pc + ("conditioners", name)
        if c.get("projection", "none") == "linear":
            cd = c.get("cond_dim") or D
            plan.normal(base + ("project", "linear", "weight"), (cd, D), 1.0 / math.sqrt(cd))
            plan.normal(base + ("project", "linear", "bias"), (D,), 0.02)
        if c.get("uncond_type") == "learned":
            plan.normal(base + ("uncond_vector",), (D,), 0.5)
        if c["type"] == "EspeakPhonemeConditioner":
            plan.normal(base + ("phoneme_embedder", "weight"), (PHONEME_VOCAB, D), 1.0)
        elif c["type"] == "FourierConditioner":
            plan.normal(base + ("weight",), (D // 2, c.get("input_dim", 1)), c.get("std", 1.0),
                        F32)
        elif c["type"] == "IntegerConditioner":
            n = int(c.get("max_val", 1)) - int(c.get("min_val", 0)) + 1
            plan.normal(base + ("int_embedder", "weight"), (n, D), 1.0)
    plan.normal(pc + ("project", "linear", "weight"), (D, D), 1.0 / math.sqrt(D))
    plan.normal(pc + ("project", "linear", "bias"), (D,), 0.02)
    plan.const(pc + ("norm", "weight"), (D,), 1.0)
    plan.const(pc + ("norm", "bias"), (D,), 0.0)


def _conv(plan, path, cout, cin, k, transposed=False, gain=1.0):
    shape = (cin, cout, k) if transposed else (cout, cin, k)
    plan.normal(path + ("weight",), shape, gain / math.sqrt(cin * k), F32)
    plan.normal(path + ("bias",), (cout,), 0.01, F32)


def _plan_dac(plan: _Plan, dac: dict) -> None:
    """The DAC's quantizer projections and codebooks and its decoder (the
    encoder serves no cell)."""
    hidden = dac["encoder_hidden_size"] * 2 ** len(dac["downsampling_ratios"])
    dh = dac["decoder_hidden_size"]
    p = ("decoder",)
    _conv(plan, p + ("conv1",), dh, hidden, 7)
    for i, s in enumerate(reversed(dac["downsampling_ratios"])):
        cin, cout = dh // 2 ** i, dh // 2 ** (i + 1)
        b = p + ("blocks", i)
        plan.special(b + ("snake",), (cin,), "alpha")
        _conv(plan, b + ("conv_t",), cout, cin, 2 * s, transposed=True)
        for r in (1, 2, 3):
            ru = b + (f"res{r}",)
            plan.special(ru + ("snake1",), (cout,), "alpha")
            _conv(plan, ru + ("conv1",), cout, cout, 7)
            plan.special(ru + ("snake2",), (cout,), "alpha")
            _conv(plan, ru + ("conv2",), cout, cout, 1, gain=0.5)
    out = dh // 2 ** len(dac["downsampling_ratios"])
    plan.special(p + ("snake",), (out,), "alpha")
    _conv(plan, p + ("conv2",), 1, out, 7, gain=0.5)
    for i in range(dac["n_codebooks"]):
        q = ("quantizers", i)
        _conv(plan, q + ("out_proj",), hidden, dac["codebook_dim"], 1)
        plan.normal(q + ("codebook",), (dac["codebook_size"], dac["codebook_dim"]), 1.0, F32)
        _conv(plan, q + ("in_proj",), dac["codebook_dim"], hidden, 1)


def _conv2(plan, path, cout, cin, k, n=None):
    lead = () if n is None else (n,)
    plan.normal(path + ("weight",), lead + (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k), F32)
    plan.normal(path + ("bias",), lead + (cout,), 0.01, F32)


def _plan_speaker(plan: _Plan, spk: dict) -> None:
    """ResNet293 (BatchNorm folded into each convolution's bias), attentive
    statistics pooling and the LDA, in the port's speaker layout."""
    ip, depths = spk["in_planes"], spk["depths"]
    _conv2(plan, ("conv1",), ip, 1, 3)
    cin = ip
    for s, (depth, stride) in enumerate(zip(depths, (1, 2, 2, 2))):
        cout = ip * 2 ** s
        base = (f"layer{s + 1}",)
        _conv2(plan, base + ("head", "conv1"), cout, cin, 3)
        _conv2(plan, base + ("head", "conv2"), cout, cout, 3)
        if stride != 1 or cin != cout:
            _conv2(plan, base + ("head", "downsample"), cout, cin, 1)
        if depth > 1:
            _conv2(plan, base + ("tail", "conv1"), cout, cout, 3, depth - 1)
            _conv2(plan, base + ("tail", "conv2"), cout, cout, 3, depth - 1)
        cin = cout
    C = ip * 8 * (spk["acoustic_dim"] // 8)
    plan.normal(("asp", "conv1", "weight"), (C, 128), 0.02, F32)
    plan.const(("asp", "conv1", "bias"), (128,), 0.0, F32)
    plan.const(("asp", "bn", "scale"), (128,), 1.0, F32)
    plan.const(("asp", "bn", "shift"), (128,), 0.0, F32)
    plan.normal(("asp", "conv2", "weight"), (128, C), 0.02, F32)
    plan.const(("asp", "conv2", "bias"), (C,), 0.0, F32)
    plan.normal(("bottleneck", "weight"), (2 * C, spk["embd_dim"]), 1.0 / math.sqrt(2 * C), F32)
    plan.const(("bottleneck", "bias"), (spk["embd_dim"],), 0.0, F32)
    plan.normal(("lda", "weight"), (spk["embd_dim"], spk["lda_dim"]),
                1.0 / math.sqrt(spk["embd_dim"]), F32)
    plan.const(("lda", "bias"), (spk["lda_dim"],), 0.0, F32)


def seed_streams(seed: int) -> dict:
    """One generator seed per tree, from the run's seed."""
    base = int(seed) % (2 ** 63)
    return {"model": base, "dac": (base * 3 + 1) % (2 ** 63), "speaker": (base * 5 + 2) % (2 ** 63)}


def make_model(cfg: dict, seed: int, device) -> dict:
    """The model's tree (bf16 weights, fp32 norms of the transformer and
    fp32 SSM scalars), with codebook 0's EOS column of the output head
    zeroed: EOS then never wins a greedy step, so every request runs to the
    length it asks for (a fixed output length, as benchmarks of servers on
    random weights fix it)."""
    plan = _Plan()
    _plan_model(plan, cfg)
    gen = torch.Generator(device).manual_seed(seed_streams(seed)["model"])
    tree = plan.build(gen, device)
    conds = tree["prefix_conditioner"]["conditioners"]
    for name, c in conds.items():  # a conditioner without a projection has an empty one
        conds[name] = {"project": c.pop("project", {}), **c}
    heads = tree["heads"]["weight"]
    heads[0, :, cfg["eos_token_id"]] = 0
    heads[:, :, cfg["codebook_size"] + 1:] = 0  # the pad columns, masked anyway
    return tree


def make_dac(dac: dict, seed: int, device) -> dict:
    plan = _Plan()
    _plan_dac(plan, dac)
    return plan.build(torch.Generator(device).manual_seed(seed_streams(seed)["dac"]), device)


def make_speaker(spk: dict, seed: int, device) -> dict:
    plan = _Plan()
    _plan_speaker(plan, spk)
    return plan.build(torch.Generator(device).manual_seed(seed_streams(seed)["speaker"]),
                      device)
