"""Plain fp32 reference of Zonos-v0.1 (the transformer and the Mamba-2
hybrid), written from the published architecture, for judging what the
served path produced.

It takes the benchmark's weights (``perfbench/lib/weights.py``; the port's
checkpoint-cache layout) and a configuration in the upstream ``config.json``
schema, and computes, teacher-forced over a whole request, the CFG-mixed
logits of every decode position: one full-sequence pass with causal
attention over all of it, no cache, no kernels, no batching of requests,
layer by layer so that only one layer's fp32 weights exist at a time.
Where the served configuration stores weights in int8, the reference
rounds the same bf16 weights to int8 itself (per output column, absmax over
the input dimension, round to nearest) and computes with the dequantized
values in fp32; ``bits=4`` gives the control's int4 (groups of 128 input
rows).

Imports nothing but ``torch`` and ``math``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# Upstream Zonos's language table puts "en-us" at index 24.
LANGUAGE_ID = {"en-us": 24}
QUANT_KEYS = ("in_proj", "out_proj", "fc1", "fc2")


def fake_quant(w: torch.Tensor, bits) -> torch.Tensor:
    """``w [..., K, N]`` in fp32 as ``bits``-bit symmetric round-to-nearest
    stores it: one scale per output column (and per group of 128 input rows
    at 4 bits); ``"fp8"``: fp8 e4m3 under one scale per output column;
    ``None`` keeps it."""
    w = w.float()
    if bits is None:
        return w
    if bits == "fp8":
        amax = w.abs().amax(dim=-2, keepdim=True)
        scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
        return (w / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = 2 ** (bits - 1) - 1
    K = w.shape[-2]
    G = K // 128 if bits == 4 and K % 128 == 0 and K > 128 else 1
    wg = w.reshape(*w.shape[:-2], G, K // G, w.shape[-1])
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(wg / scale), -qmax, qmax)
    return (q * scale).reshape(w.shape)


class Reference:
    """``weights``: ``None`` (as stored), 8, 4 or ``"fp8"``: the precision
    of every backbone projection and of the output heads."""

    def __init__(self, cfg: dict, params: dict, weights: int | None = None):
        self.cfg = cfg
        self.bb = cfg["backbone"]
        self.p = params
        self.bits = weights
        self.D = self.bb["d_model"]
        self.K = cfg["num_codebooks"]
        self.eps = self.bb.get("norm_epsilon", 1e-5)

    # -- conditioning ------------------------------------------------------

    def _linear(self, p, x):
        return x @ p["weight"].float() + p["bias"].float()

    def _project(self, p, x):
        if "linear" in p:
            return self._linear(p["linear"], x)
        if "mlp0" in p:
            return self._linear(p["mlp2"], F.silu(self._linear(p["mlp0"], x)))
        return x

    def conditioning(self, values: dict) -> torch.Tensor:
        """``values``: conditioner name -> input for the conditioned row
        (phoneme ids ``[L]`` for ``espeak``; a list of floats, or an int,
        otherwise); names missing use the learned unconditional vector. The
        unconditioned row keeps only the conditioners without one (the
        phonemes). Returns ``[2, L + n, D]`` fp32: the conditioners'
        outputs in configuration order, projected and layer-normed."""
        pc = self.p["prefix_conditioner"]
        rows = []
        for side in ("cond", "uncond"):
            parts = []
            for c in self.cfg["prefix_conditioner"]["conditioners"]:
                name = c.get("name", c["type"])
                p = pc["conditioners"][name]
                learned = c.get("uncond_type") == "learned"
                v = values.get(name) if (side == "cond" or not learned) else None
                if v is None:
                    parts.append(p["uncond_vector"].float()[None])
                    continue
                if c["type"] == "EspeakPhonemeConditioner":
                    x = p["phoneme_embedder"]["weight"].float()[torch.as_tensor(v).long()]
                elif c["type"] == "FourierConditioner":
                    lo, hi = c.get("min_val", 0.0), c.get("max_val", 1.0)
                    val = torch.as_tensor(v, dtype=torch.float32, device=pc["norm"]["weight"].device)
                    val = (val.reshape(1, -1) - lo) / (hi - lo)
                    f = 2 * math.pi * val @ p["weight"].float().T
                    x = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
                elif c["type"] == "IntegerConditioner":
                    x = p["int_embedder"]["weight"].float()[int(v) - int(c.get("min_val", 0))][None]
                else:  # passthrough (the speaker embedding)
                    x = torch.as_tensor(v, dtype=torch.float32,
                                        device=pc["norm"]["weight"].device).reshape(1, -1)
                parts.append(self._project(p.get("project", {}), x))
            cat = torch.cat(parts, dim=0)
            out = self._project(pc["project"], cat)
            rows.append(F.layer_norm(out, (self.D,), pc["norm"]["weight"].float(),
                                     pc["norm"]["bias"].float(), 1e-5))
        return torch.stack(rows)

    # -- backbones -----------------------------------------------------------

    def _w(self, leaf: dict, name: str) -> torch.Tensor:
        w = leaf["weight"]
        return fake_quant(w, self.bits) if name in QUANT_KEYS else w.float()

    @staticmethod
    def _attend(q, k, v):
        """Causal GQA over the whole sequence: q ``[B, S, Hq, Dh]``, k and
        v ``[B, S, Hkv, Dh]``; every position attends all earlier ones,
        padding included."""
        B, S, Hq, Dh = q.shape
        g = Hq // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(Dh)
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
        return torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)

    @staticmethod
    def _rope_pairs(x, pos, base=10000.0):
        """Interleaved-pair RoPE over the whole head dim."""
        d = x.shape[-1]
        inv = 1.0 / base ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
        ang = (pos.double()[:, None] * inv[None]).float()  # [S, d/2]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).flatten(-2)

    @staticmethod
    def _rope_half(x, pos, rd, base=10000.0):
        """Rotate-half RoPE on the first ``rd`` features of each head."""
        inv = 1.0 / base ** (torch.arange(0, rd, 2, device=x.device, dtype=torch.float64) / rd)
        ang = (pos.double()[:, None] * inv[None]).float()
        cos = torch.cat([torch.cos(ang)] * 2, -1)[None, :, None]
        sin = torch.cat([torch.sin(ang)] * 2, -1)[None, :, None]
        xr = x[..., :rd]
        x1, x2 = xr.chunk(2, dim=-1)
        return torch.cat([xr * cos + torch.cat([-x2, x1], -1) * sin, x[..., rd:]], dim=-1)

    def _geometry(self):
        a = self.bb.get("attn_cfg") or {}
        hq = a.get("num_heads", 16)
        hybrid = bool(self.bb.get("ssm_cfg"))
        hkv = a.get("num_heads_kv", hq if hybrid else max(hq // 4, 1))
        dh = a.get("head_dim", self.D // hq)
        return hq, hkv, dh, (a.get("rotary_emb_dim", dh // 2) if hybrid else None)

    def _attention(self, lp, x, pos):
        hq, hkv, dh, rd = self._geometry()
        B, S, _ = x.shape
        q, k, v = (x @ self._w(lp["in_proj"], "in_proj")).split([hq * dh, hkv * dh, hkv * dh], -1)
        q, k, v = q.reshape(B, S, hq, dh), k.reshape(B, S, hkv, dh), v.reshape(B, S, hkv, dh)
        if rd is None:
            q, k = self._rope_pairs(q, pos), self._rope_pairs(k, pos)
        else:
            q, k = self._rope_half(q, pos, rd), self._rope_half(k, pos, rd)
        y = self._attend(q, k, v).reshape(B, S, hq * dh)
        return y @ self._w(lp["out_proj"], "out_proj")

    def _mlp(self, lp, x):
        y, gate = (x @ self._w(lp["fc1"], "fc1")).chunk(2, dim=-1)
        return (y * F.silu(gate)) @ self._w(lp["fc2"], "fc2")

    def _rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w.float()

    def _mamba(self, lp, x):
        """Mamba-2 over the whole sequence in its quadratic (attention-like)
        form: ``y_i = sum_{j <= i} (C_i . B_j) exp(sum_{j < s <= i} dt_s A)
        dt_j x_j + D x_i`` per head, then the gated RMSNorm and out_proj."""
        s = self.bb["ssm_cfg"]
        B_, S, _ = x.shape
        d_inner = s.get("expand", 2) * self.D
        N, P = s.get("d_state", 128), s.get("headdim", 64)
        H = d_inner // P
        z, xbc, dt = (x @ self._w(lp["in_proj"], "in_proj")).split(
            [d_inner, d_inner + 2 * N, H], -1)
        w = lp["conv1d"]["weight"].float()  # [d_conv, C]: tap k meets x[t - (d_conv - 1 - k)]
        kc = w.shape[0]
        xp = F.pad(xbc, (0, 0, kc - 1, 0))
        conv = lp["conv1d"]["bias"].float() + sum(xp[:, k: k + S] * w[k] for k in range(kc))
        xs, Bm, Cm = F.silu(conv).split([d_inner, N, N], -1)
        dt = F.softplus(dt + lp["dt_bias"].float())  # [B, S, H]
        A = -torch.exp(lp["A_log"].double())
        cum = torch.cumsum(dt.double() * A, dim=1)  # [B, S, H]
        seg = cum.permute(0, 2, 1)[..., :, None] - cum.permute(0, 2, 1)[..., None, :]
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal, float("-inf"))).float()  # [B, H, S, S]
        cb = Cm @ Bm.transpose(1, 2)  # [B, S, S]
        xh = xs.reshape(B_, S, H, P)
        scores = decay * cb[:, None] * dt.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", scores, xh)
        y = y + xh * lp["D"].float()[None, None, :, None]
        g = y.reshape(B_, S, d_inner) * F.silu(z)
        return self._rms(g, lp["ssm_norm"]["weight"]) @ self._w(lp["out_proj"], "out_proj")

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, S, D]`` fp32 at positions ``0 .. S-1`` -> the final norm's
        output."""
        bb = self.p["backbone"]
        pos = torch.arange(x.shape[1], device=x.device)
        if not self.bb.get("ssm_cfg"):
            lay = bb["layers"]
            for i in range(self.bb["n_layer"]):
                lp = {k: {n: t[i] for n, t in v.items()} for k, v in lay.items()}
                h = F.layer_norm(x, (self.D,), lp["norm1"]["weight"].float(),
                                 lp["norm1"]["bias"].float(), self.eps)
                x = x + self._attention(lp, h, pos)
                h = F.layer_norm(x, (self.D,), lp["norm2"]["weight"].float(),
                                 lp["norm2"]["bias"].float(), self.eps)
                x = x + self._mlp(lp, h)
            nf = bb["norm_f"]
            return F.layer_norm(x, (self.D,), nf["weight"].float(), nf["bias"].float(), self.eps)
        attn = set(self.bb["attn_layer_idx"])
        counts = {"attn": 0, "mamba": 0}
        residual = torch.zeros_like(x)
        hidden = x
        for i in range(self.bb["n_layer"]):
            kind = "attn" if i in attn else "mamba"
            j = counts[kind]
            counts[kind] += 1
            lp = {k: ({n: t[j] for n, t in v.items()} if isinstance(v, dict) else v[j])
                  for k, v in bb[kind].items()}
            residual = hidden + residual
            h = self._rms(residual, lp["norm"]["weight"])
            hidden = self._attention(lp, h, pos) if kind == "attn" else self._mamba(lp, h)
            if "fc1" in lp:
                residual = hidden + residual
                hidden = self._mlp(lp, self._rms(residual, lp["norm2"]["weight"]))
        return self._rms(hidden + residual, bb["norm_f"]["weight"])

    # -- heads and the served tokens ----------------------------------------

    def logits(self, cond: torch.Tensor, delayed: torch.Tensor,
               cfg_scale: float = 2.0) -> torch.Tensor:
        """``cond [2, Lc, D]``, ``delayed [K, n]`` the delayed code columns
        ``0 .. n-1`` -> CFG-mixed fp32 logits ``[K, n, V]`` predicting
        columns ``1 .. n``, with EOS masked outside codebook 0 and the
        vocabulary past EOS masked."""
        emb = self.p["embeddings"]["weight"]
        e = sum(emb[k].float()[delayed[k].long()] for k in range(self.K))  # [n, D]
        x = torch.cat([cond, e[None].expand(2, -1, -1)], dim=1)
        h = self.backbone(x)[:, cond.shape[1]:]  # column j's position predicts column j + 1
        heads = self.p["heads"]["weight"]
        out = []
        for k in range(self.K):
            w = fake_quant(heads[k], self.bits)
            out.append(h @ w)  # [2, n, Vp]
        lg = torch.stack(out, dim=1)  # [2, K, n, Vp]
        lg = lg[1] + (lg[0] - lg[1]) * cfg_scale
        V = self.cfg["codebook_size"] + 1
        lg[..., V:] = NEG_INF
        lg[1:, :, self.cfg["eos_token_id"]] = NEG_INF
        return lg


def delay(codes: torch.Tensor, mask_token: int) -> torch.Tensor:
    """Codes ``[K, T]`` -> delayed columns ``[K, T + 1]`` (columns ``0 ..
    T``): codebook ``k`` shifted right by ``k + 1``, the mask token before
    it; columns past ``T`` are not needed."""
    K, T = codes.shape
    out = torch.full((K, T + 1), mask_token, dtype=torch.long, device=codes.device)
    for k in range(K):
        out[k, k + 1:] = codes[k, : T - k]
    return out


def penalized(logits: torch.Tensor, delayed: torch.Tensor, penalty: float,
              window: int) -> torch.Tensor:
    """The repetition penalty of a greedy step: the logit of each token
    met among the last ``window`` delayed columns of its codebook is
    divided by ``penalty`` per occurrence where positive, multiplied where
    not. ``logits [K, n, V]`` predict columns ``1 .. n``; the column ``1``
    (drawn at the prefill) takes no penalty."""
    K, n, V = logits.shape
    counts = torch.zeros_like(logits)
    for w in range(1, window + 1):
        src = torch.arange(1, n + 1, device=logits.device) - w  # column c - w
        ok = (src >= 0) & (torch.arange(1, n + 1, device=logits.device) >= 2)
        tok = delayed[:, src.clamp(min=0)].clamp(max=V - 1)  # [K, n]
        counts.scatter_add_(-1, tok[..., None], ok[None, :, None].float().expand(K, n, 1))
    factors = penalty ** counts
    return torch.where(logits <= 0, logits * factors, logits / factors)


def widest_gap(pen: torch.Tensor, delayed: torch.Tensor) -> tuple[float, int]:
    """The widest gap by which a served token's (penalized) logit lies
    below the best, over every column ``c`` in ``1 .. n`` and codebook
    ``k < c`` (the rest of a column is the delay pattern's mask); and the
    number of tokens judged. ``delayed [K, n + 1]``."""
    K, n, _ = pen.shape
    served = delayed[:, 1: n + 1]
    got = torch.gather(pen, -1, served[..., None])[..., 0]
    gap = pen.max(dim=-1).values - got
    c = torch.arange(1, n + 1, device=pen.device)[None, :]
    judged = torch.arange(K, device=pen.device)[:, None] < c
    return float(gap[judged].max()), int(judged.sum())


def control_gap(pen_ref: torch.Tensor, pen_low: torch.Tensor, delayed: torch.Tensor) -> float:
    """The control's reading: at each judged position, the reference's gap
    of the token a lower precision puts first."""
    K, n, _ = pen_ref.shape
    pick = pen_low.argmax(dim=-1)
    got = torch.gather(pen_ref, -1, pick[..., None])[..., 0]
    gap = pen_ref.max(dim=-1).values - got
    c = torch.arange(1, n + 1, device=pen_ref.device)[None, :]
    judged = torch.arange(K, device=pen_ref.device)[:, None] < c
    return float(gap[judged].max())
