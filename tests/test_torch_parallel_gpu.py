"""The kernels at the rank-local shapes the parallel layer gives them, on the
card: decode attention (row 1) with a tensor-parallel rank's 16/4 and 8/2
heads, at a data rank's single row and with a pipeline stage's 13-layer
cache; the prefill (row 3) at those heads; ``qmm_int8`` (row 4) at TP 2's
widths, with the fp32 output a row-parallel partial takes. The hybrid's and
int4's: the fused Mamba step's partial-norm mode (row 10 on a rank's heads)
against its plain version, and n ranks' folded outputs against the
full-width kernel; ``qmm_int4`` at the padded Mamba in_proj and the split
contractions; ``qmm_int8`` at the Mamba in_proj's local widths. And the
prefill kernel on a second card, whose shared-memory attribute is its own.
Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -q

Without a card every test here skips.
"""

import pytest
import torch

from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_layered,
    decode_attention_layered_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
    prefill_attention,
    prefill_attention_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.mamba_step import (
    ssd_gate_step_layered,
    ssd_gate_step_partial_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int4, qmm_int4_plain, qmm_int8, qmm_int8_plain

pytestmark = pytest.mark.gpu

D, STAGE = 64, 128
TOL = dict(rtol=2e-2, atol=2e-2)  # as tests/test_torch_kernels_gpu.py
QMM_TOL = {torch.bfloat16: dict(rtol=8e-3, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-4)}
# The fused Mamba step, as tests/test_torch_kernels_gpu.py holds it: the bf16
# output, the fp32 state, and a bf16 state within one rounding step.
SSM_TOL = dict(rtol=1e-2, atol=1e-2)
SSM_STATE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                 torch.bfloat16: dict(rtol=8e-3, atol=1e-2)}
M_N, M_HP, M_H = 128, 4096, 64  # the hybrid's d_state, d_inner and Mamba heads


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("heads,layers", [((16, 4), 26), ((8, 2), 26), ((32, 8), 13)],
                         ids=["tp2", "tp4", "pp2"])
@pytest.mark.parametrize("batch", [2, 1])
@pytest.mark.parametrize("T,flushed_end,stage_len", [(528, 472, 54), (960, 904, 54),
                                                     (960, 0, 0)])
def test_decode_attention_rank_local(dev, heads, layers, batch, T, flushed_end, stage_len):
    gen = torch.Generator(device=dev).manual_seed(T + batch)
    hq, hkv = heads
    W = hkv * D
    x = dict(q=_randn(gen, batch, 1, hq, D, dev=dev),
             k_cache=_randn(gen, layers, batch, T, W, dev=dev),
             v_cache=_randn(gen, layers, batch, T, W, dev=dev),
             k_stage=_randn(gen, layers, batch, STAGE, W, dev=dev),
             v_stage=_randn(gen, layers, batch, STAGE, W, dev=dev),
             k_cur=_randn(gen, batch, W, dev=dev), v_cur=_randn(gen, batch, W, dev=dev))
    for layer in (0, layers - 1):
        sc = torch.tensor([flushed_end, stage_len, layer], dtype=torch.int32, device=dev)
        want = decode_attention_layered_plain(**{k: v.clone() for k, v in x.items()}, scalars=sc)
        got = decode_attention_layered(**x, scalars=sc)
        torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.parametrize("heads", [(16, 4), (8, 2)], ids=["tp2", "tp4"])
@pytest.mark.parametrize("S,T", [(88, 528), (519, 960)])
def test_prefill_attention_rank_local(dev, heads, S, T):
    gen = torch.Generator(device=dev).manual_seed(S)
    hq, hkv = heads
    q = _randn(gen, 2, S, hq, D, dev=dev)
    k, v = _randn(gen, 2, T, hkv * D, dev=dev), _randn(gen, 2, T, hkv * D, dev=dev)
    want = prefill_attention_plain(q, k[:, :S], v[:, :S], 0)
    k[:, S:] = float("nan")
    v[:, S:] = float("nan")
    torch.testing.assert_close(prefill_attention(q, k, v, 0).float(), want.float(), **TOL)


@pytest.mark.parametrize("G,K,N,out_dtype", [
    (1, 2048, 1536, torch.bfloat16), (1, 1024, 2048, torch.float32),
    (1, 2048, 8192, torch.bfloat16), (1, 4096, 2048, torch.float32),
    (9, 2048, 576, torch.float32)], ids=["in_proj", "out_proj", "fc1", "fc2", "heads"])
@pytest.mark.parametrize("M", [1, 2, 176])
def test_qmm_int8_tp2_widths(dev, G, K, N, out_dtype, M):
    gen = torch.Generator(device=dev).manual_seed(K + N + M)
    wq = quant.quantize_weight(_randn(gen, G, K, N, dev=dev) / K ** 0.5)
    x = _randn(gen, M, K, dev=dev)
    got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
    want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])


def test_prefill_attention_on_a_second_card(dev):
    """The kernel's shared-memory attribute is set per device: after the
    first card's launch, one on the second card (made current) still
    launches and agrees with the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card: the attribute flag per device is held on one only "
                    "by the first card's launches")
    gen0 = torch.Generator(device="cuda:0").manual_seed(0)
    q0 = _randn(gen0, 2, 600, 32, D, dev="cuda:0")
    k0, v0 = _randn(gen0, 2, 600, 8 * D, dev="cuda:0"), _randn(gen0, 2, 600, 8 * D, dev="cuda:0")
    prefill_attention(q0, k0, v0, 0)
    torch.cuda.set_device(1)
    try:
        q1, k1, v1 = (t.to("cuda:1") for t in (q0, k0, v0))
        before = build.LAUNCHES["prefill_attention"]
        got = prefill_attention(q1, k1, v1, 0)
        torch.cuda.synchronize(1)
        assert build.LAUNCHES["prefill_attention"] == before + 1
        torch.testing.assert_close(got.float(), prefill_attention_plain(q1, k1, v1, 0).float(),
                                   **TOL)
    finally:
        torch.cuda.set_device(0)


def _ssd_inputs(gen, batch, hp, heads, state_dtype, dev):
    def f(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    dt = torch.nn.functional.softplus(f(batch, heads))
    state = f(1, batch, M_N, hp).to(state_dtype)
    return state, dict(xs=f(batch, hp).bfloat16(), dt=dt,
                       decay=torch.exp(-dt * torch.rand(heads, generator=gen, device=dev)),
                       bm=f(batch, M_N) * 0.3, cm=f(batch, M_N) * 0.3, z=f(batch, hp).bfloat16(),
                       d_skip=f(heads), norm_w=(1.0 + 0.1 * f(hp)).bfloat16())


@pytest.mark.parametrize("n", [2, 4], ids=["tp2", "tp4"])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_partial_norm_mode_against_plain_and_full_width(dev, n, batch, state_dtype):
    """A rank's HP / n columns (2048 at TP 2, 1024 at TP 4): ``g * w``, the
    row sums of ``g^2`` (1e-5 relative) and the state against the plain
    version; then n ranks' partial outputs, scaled by ``rsqrt(sum of their
    sums / HP + eps)``, against the full-width kernel's output."""
    gen = torch.Generator(device=dev).manual_seed(n * 10 + batch)
    hp, heads = M_HP // n, M_H // n
    state, x = _ssd_inputs(gen, batch, hp, heads, state_dtype, dev)
    ref = state.clone()
    want_gw, want_ss = ssd_gate_step_partial_plain(ref, 0, **x)
    before = build.LAUNCHES["ssd_gate_step_partial"]
    gw, ss = ssd_gate_step_layered(state, 0, **x, partial=True)
    assert build.LAUNCHES["ssd_gate_step_partial"] == before + 1
    torch.testing.assert_close(gw.float(), want_gw.float(), **SSM_TOL)
    torch.testing.assert_close(ss, want_ss, rtol=1e-5, atol=0)
    torch.testing.assert_close(state.float(), ref.float(), **SSM_STATE_TOL[state_dtype])
    full, xf = _ssd_inputs(gen, batch, M_HP, M_H, state_dtype, dev)
    parts = [full[..., r * hp: (r + 1) * hp].contiguous() for r in range(n)]
    want = ssd_gate_step_layered(full, 0, **xf)
    outs = []
    for r in range(n):
        xr = {k: (t if k in ("bm", "cm") else
                  t[..., r * t.shape[-1] // n: (r + 1) * t.shape[-1] // n].contiguous())
              for k, t in xf.items()}
        outs.append(ssd_gate_step_layered(parts[r], 0, **xr, partial=True))
    scale = torch.rsqrt(sum(o[1] for o in outs) / M_HP + 1e-5)[:, None]
    got = torch.cat([o[0].float() for o in outs], dim=-1) * scale
    torch.testing.assert_close(got, want.float(), **SSM_TOL)


@pytest.mark.parametrize("K,N,pad", [(2048, 4384, 0), (2048, 2336, 16), (2048, 2048, 0),
                                     (1024, 2048, 0), (4096, 2048, 0), (2048, 4096, 0)],
                         ids=["mamba_in_tp2", "mamba_in_tp4_padded", "split_2048",
                              "split_1024", "fc2_tp2", "fc1_tp4"])
@pytest.mark.parametrize("M", [1, 2, 186])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_qmm_int4_rank_local(dev, K, N, pad, M, out_dtype):
    """``qmm_int4`` (groups of 128) at the hybrid's Mamba in_proj widths (TP 4's
    2320 columns padded with zero columns and scales to 2336) and at the
    contractions a row-parallel rank holds, bf16 and the fp32 partial."""
    gen = torch.Generator(device=dev).manual_seed(K + N + M)
    leaf = quant.quantize_weight(_randn(gen, K, N, dev=dev) / K ** 0.5, bits=4, group_size=128,
                                 clip_search=True)
    if pad:
        leaf["weight_int4"][:, (N - pad) // 2:] = 0
        leaf["scale"][..., N - pad:] = 0
    x = _randn(gen, M, K, dev=dev)
    got = qmm_int4(x, leaf["weight_int4"], leaf["scale"], out_dtype)
    want = qmm_int4_plain(x, leaf["weight_int4"], leaf["scale"], out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
    if pad:
        assert not got[:, N - pad:].any()


@pytest.mark.parametrize("N", [4384, 2320], ids=["tp2", "tp4"])
@pytest.mark.parametrize("M", [1, 2, 186])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_qmm_int8_mamba_in_proj_rank_local(dev, N, M, out_dtype):
    gen = torch.Generator(device=dev).manual_seed(N + M)
    wq = quant.quantize_weight(_randn(gen, 1, 2048, N, dev=dev) / 2048 ** 0.5)
    x = _randn(gen, M, 2048, dev=dev)
    got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
    want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
