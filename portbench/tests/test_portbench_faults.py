"""The rest of a run, past the look for a card, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have.
Tiny configurations on the CPU in float32, held to the cells' own limits;
the sound run beside them comes out true."""

import copy

import pytest
import torch

from portbench import run as bench_run
from portbench.harness import spec
from portbench.runners import ddib as ddib_runner
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**35 + 11


def _result(family, runner, monkeypatch=None, **kw):
    limits = spec.load_json(spec.PACKAGE / "limits" / (
        {"ddim": "ddim128", "sd": "sd21_128"}[family]
        + {"ddib": ".ddib", "train": ".train" if family == "ddim" else ".finetune"}[runner]
        + ".json"))
    if runner == "ddib":
        mix = dict(batch=8, compute_dtype="float32", checked_rows_per_batch=4,
                   num_inference_steps=3)
    else:
        mix = dict(batch=4, mixed_precision="no", reference_rows_per_block=4, pool_batches=4)
    cell = tiny.cell(family, runner, limits, **dict(mix, **kw))
    out = cell.runner().run(cell, cell.family(), SEED, 0.2, False, CPU, lambda: 0.0)
    return bench_run.result(cell, out, False, CPU)


@pytest.fixture
def odd_rows_checked():
    rows = ddib_runner.checked_rows({"batch": 8, "checked_rows_per_batch": 4}, SEED, 0, CPU)
    assert (rows % 2 == 1).any() and (rows % 2 == 0).any()


@pytest.mark.parametrize("family", ["ddim", "sd"])
def test_a_sound_transfer_is_correct(family):
    assert _result(family, "ddib")["correct"]


@pytest.mark.parametrize("family", ["ddim", "sd"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_broken_transfer_is_not_correct(family, fault, monkeypatch, odd_rows_checked):
    from phendiff_tpu_torch.pipelines import transfer

    real = transfer.ddib

    def broken(denoiser, schedule, x, src, tgt, **kw):
        if fault == "state_unchanged":
            for _ in range(2 * kw["num_inference_steps"]):
                denoiser(x.float(), torch.zeros(len(x), dtype=torch.long), src)
            return x.float()
        if fault == "half_batch":  # the odd rows left out: they take their even neighbour's
            out = real(denoiser, schedule, x, src, tgt, **kw)
            out[1::2] = out[0::2]
            return out
        calls = []

        def altered(xx, t, emb):  # one call's answer altered where it is produced
            y = denoiser(xx, t, emb)
            calls.append(1)
            return y + 1.0 if len(calls) == 3 else y

        return real(altered, schedule, x, src, tgt, **kw)

    monkeypatch.setattr(transfer, "ddib", broken)
    line = _result(family, "ddib")
    assert not line["correct"], line["checked"]


@pytest.mark.parametrize("family", ["ddim", "sd"])
def test_a_sound_training_run_is_correct(family):
    assert _result(family, "train")["correct"]


@pytest.mark.parametrize("family", ["ddim", "sd"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(family, fault, monkeypatch):
    from phendiff_tpu_torch.train import train_loop

    real = train_loop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def broken(state, batch, draws):
            if fault == "state_unchanged":
                return state, step(copy.deepcopy(state), batch, draws)[1]
            n = batch[0].shape[0] // 2
            return step(state, (batch[0][:n], batch[1][:n]), draws.rows(slice(0, n)))

        return broken

    monkeypatch.setattr(train_loop, "make_train_step", make)
    line = _result(family, "train")
    assert not line["correct"], line["checked"]
