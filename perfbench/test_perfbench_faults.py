"""Whole runs of a tiny cell on the CPU (the harness's look for a chip
skipped), sound and with the timed path broken underneath once set-up is
done: ``correct`` has to come out true, then false for each fault a served
cell can have. (The exchange between chips does not exist on one chip.)"""

from __future__ import annotations

import pytest

from perfbench.conftest import tiny_spec
from perfbench.run import Run

SEED = 2 ** 31 + 4242


def run_with(fault=None, **mix):
    run = Run(tiny_spec(**mix), SEED, 3.0, traced=False, device="cpu")
    run.before_load = fault
    return run.execute()


def test_a_sound_run_is_correct():
    out = run_with()
    assert out["correct"], out["check"]
    assert out["check"]["logit_gap"]["value"] < out["check"]["logit_gap"]["limit"]
    assert {"audio_s_per_s", "setup_s"} <= set(out["metrics"])
    assert out["failed"] == 0


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from zonos_vibes_tpu_torch.engine import pool

    def plant():
        orig = pool.sample_from_logits_dyn

        def altered(*a, **kw):
            tok = orig(*a, **kw)
            tok[:, 3] = (tok[:, 3] + 1) % 1024
            return tok

        monkeypatch.setattr(pool, "sample_from_logits_dyn", altered)

    out = run_with(plant)
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from zonos_vibes_tpu_torch.engine import graphs

    def plant():
        monkeypatch.setattr(graphs.StepGraph, "run", lambda self, n: None)

    out = run_with(plant, grace_s=8.0)
    assert not out["correct"]
    assert out["check"]["unanswered"]["value"] > 0


def test_half_of_the_batch_left_out(monkeypatch):
    from zonos_vibes_tpu_torch.models.zonos import ZonosModel

    def plant():
        orig = ZonosModel.compute_logits

        def half(self, *a, **kw):
            out = orig(self, *a, **kw)
            if kw.get("positions") is not None:  # a pooled step: rows past the first half
                h = out.shape[0] // 2  # take the mean of the rest
                out[h:] = out[:h].mean(dim=0, keepdim=True)
            return out

        monkeypatch.setattr(ZonosModel, "compute_logits", half)

    out = run_with(plant, check={"requests": 6})
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct():
    """The control (the reference with int4 weights, the DAC with TF32)
    judged where the served tokens and PCM were: ``correct`` false."""
    run = Run(tiny_spec(), SEED, 3.0, traced=False, device="cpu", control=True)
    out = run.execute()
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


@pytest.mark.gpu
def test_control_fails_the_cells_limits_on_the_card(cuda):
    """On the card at a cell's own size: a short sound run comes out
    correct, and the same run with the control in the program's place (the
    reference one precision step down, the DAC with TF32) does not."""
    from perfbench.run import load_cell

    for cell in ("tfm-int8.pool8-narration", "hyb-bf16.pool8-narration"):
        sound = Run(load_cell(cell), SEED, 10.0, traced=False).execute()
        assert sound["correct"], (cell, sound["check"])
        ctl = Run(load_cell(cell), SEED, 10.0, traced=False, control=True).execute()
        assert not ctl["correct"], (cell, ctl["check"])
