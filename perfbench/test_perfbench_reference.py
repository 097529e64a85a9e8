"""The plain reference agrees with the port at a tiny size on the CPU, and
its control (one step lower in precision) does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.conftest import tiny_spec
from perfbench.lib import weights as W
from perfbench.reference import codec, zonos

UNCOND = ["emotion", "vqscore_8", "fmax", "pitch_std", "dnsmos_ovrl", "speaker_noised"]


def fp32(tree):
    if isinstance(tree, dict):
        return {k: fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [fp32(v) for v in tree]
    return tree.float()


def program(spec, dtype_fp32=True):
    from zonos_vibes_tpu_torch.config import ZonosConfig
    from zonos_vibes_tpu_torch.models.dac import DACConfig
    from zonos_vibes_tpu_torch.models.speaker import SpeakerEncoder
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

    cfg = spec["config"]
    params = W.make_model(cfg["model"], 5, "cpu")
    dacp = W.make_dac(cfg["dac"], 5, "cpu")
    dac_kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["dac"].items()}
    pipe = ZonosPipeline.from_params(ZonosConfig.from_dict(cfg["model"]),
                                     fp32(params) if dtype_fp32 else params, dac_params=dacp,
                                     device="cpu", dac_config=DACConfig(**dac_kw))
    spk = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["speaker"].items()}
    pipe.speaker_encoder = SpeakerEncoder(**spk)
    pipe.speaker_params = W.make_speaker(cfg["speaker"], 5, "cpu")
    return pipe, params, dacp


@pytest.mark.parametrize("cell", ["tfm-int8.pool8-narration", "hyb-bf16.pool8-narration"])
def test_reference_equals_the_port_in_fp32(cell):
    from zonos_vibes_tpu_torch.ops.sampling import SamplingParams

    spec = tiny_spec(cell)
    pipe, params, dacp = program(spec)
    wav = np.random.default_rng(0).standard_normal(32000).astype(np.float32) * 0.1
    e_prog = pipe.speaker_encoder(pipe.speaker_params, wav, 16000)[1][0]
    e_ref = codec.speaker_embedding(pipe.speaker_params, torch.from_numpy(wav))
    assert torch.allclose(e_prog, e_ref, atol=1e-5)

    ids = [2, 40, 41, 42, 5, 50, 3]
    cd = pipe.make_cond_dict(text="x", speaker=e_ref.reshape(1, 1, -1), ctc_loss=0.0,
                             unconditional_keys=UNCOND, _phoneme_ids=[ids])
    prefix = pipe.prepare_conditioning(cd)
    mcfg = spec["config"]["model"]
    ref = zonos.Reference(mcfg, fp32(params))
    values = {"espeak": torch.tensor(ids), "speaker": e_ref, "speaking_rate": [15.0],
              "language_id": zonos.LANGUAGE_ID["en-us"], "ctc_loss": [0.0]}
    cond = ref.conditioning(values)
    assert torch.allclose(prefix.float(), cond, atol=1e-5)

    res = pipe.engine.generate(pipe.params, prefix, None, generator=torch.Generator().manual_seed(0),
                               max_new_tokens=40, sampling_params=SamplingParams(temperature=0))
    codes = res.codes[0]
    delayed = zonos.delay(codes, mcfg["masked_token_id"])
    pen = zonos.penalized(ref.logits(cond, delayed[:, :40]), delayed, 3.0, 2)
    gap, judged = zonos.widest_gap(pen, delayed)
    assert judged == 9 * 40 - 36 and gap == 0.0
    # The control: int4 weights put other tokens first.
    low = zonos.Reference(mcfg, fp32(params), weights=4)
    pl = zonos.penalized(low.logits(cond, delayed[:, :40]), delayed, 3.0, 2)
    assert zonos.control_gap(pen, pl, delayed) > 0.1
    # A token altered where it is produced shows as a wide gap.
    bad = delayed.clone()
    bad[3, 20] = (bad[3, 20] + 1) % 1024
    assert zonos.widest_gap(pen, bad)[0] > 0.0

    wav_prog = pipe.decode_audio(codes[None])[0]
    wav_ref = codec.dac_decode(dacp, codes).numpy()
    assert np.abs(wav_prog - wav_ref).max() < 1e-5


def test_fake_quant_noise_orders():
    w = torch.randn(512, 256)
    err = {b: float((zonos.fake_quant(w, b) - w).pow(2).mean().sqrt()) for b in (8, "fp8", 4)}
    assert err[8] < err["fp8"] < err[4]
    assert torch.equal(zonos.fake_quant(w, None), w)
