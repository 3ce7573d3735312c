"""A run whose timed path is broken underneath comes out not correct, and
its control reads far above the program.

The harness runs on the CPU at tiny widths (its look for a card skipped),
through the whole of a run: the server, the load generator, the window and
the check. The faults a served single-card cell can have: a decode step
that returns its state unchanged, half of the batch left out (its slots
served the other half's logits), a token altered where it is produced. A
cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import pytest
import torch

PAGED = "mistral7b-int8-paged-sharedprefix-c64"


def _step_keeps_state(real):
    def step(spec, params, cache, ids, active, dtype):
        lengths = cache.lengths.clone()
        out = real(spec, params, cache, ids, active, dtype)
        cache.lengths.copy_(lengths)
        return out
    return step


def _half_batch_left_out(real):
    def step(spec, params, cache, ids, active, dtype):
        cache, logits = real(spec, params, cache, ids, active, dtype)
        logits = logits.clone()
        logits[1::2] = logits[0::2][: logits[1::2].shape[0]]
        return cache, logits
    return step


def _altered_token(self, logits, snap, prog):
    return (torch.argmax(logits, dim=-1).to(torch.int32) + 1) % self.spec.vocab


FAULTS = {
    "state_unchanged": lambda gen, mp: (
        mp.setattr(gen, "decode_step", _step_keeps_state(gen.decode_step)),
        mp.setattr(gen, "paged_decode_step", _step_keeps_state(gen.paged_decode_step))),
    "half_batch_left_out": lambda gen, mp: (
        mp.setattr(gen, "decode_step", _half_batch_left_out(gen.decode_step)),
        mp.setattr(gen, "paged_decode_step", _half_batch_left_out(gen.paged_decode_step))),
    "token_altered": lambda gen, mp: mp.setattr(gen.GenerationEngine, "_sample",
                                                _altered_token),
}


def test_a_sound_run_is_correct_and_its_control_reads_higher(tiny_bench):
    res = tiny_bench.run(PAGED, control=True)
    checks = res["checks"]
    assert res["correct"], checks
    assert not res["control_correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert checks["control_max_gap"]["value"] > 3 * checks["max_gap"]["value"]
    assert set(res["metrics"]) == {"output_tok_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault):
    from starpu_inference_server_tpu_torch.serving import generation

    FAULTS[fault](generation, monkeypatch)
    res = tiny_bench.run(PAGED)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_gap"]["value"] > res["checks"]["max_gap"]["limit"]
