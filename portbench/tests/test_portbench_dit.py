"""The ``dit`` family (DiT-XL/2 over SD's VAE) and the data-parallel
training runner: the family's parameters and work counts at full width on
the meta device, a tiny DiT transfer judged on the CPU (sound: correct;
state left unchanged: not), and the data-parallel fine-tune at two gloo
ranks on the CPU against the reference over all the global rows."""

import copy

import pytest
import torch

from portbench import run as bench_run
from portbench.families import dit, sd
from portbench.harness import spec
from portbench.reference import dit as RD
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2**35 + 23
DIT = spec.load_json(spec.PACKAGE / "configs" / "dit_xl2_512.json")

TINY = {
    "name": "dit_tiny", "family": "dit", "resolution": 64, "reduced": [],
    "dit": {"input_size": 8, "patch_size": 2, "in_channels": 4, "hidden_size": 144, "depth": 2,
            "num_heads": 2, "mlp_ratio": 4.0, "num_classes": 10,
            "learn_sigma": True},
    "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
            "block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4,
            "sample_size": 64, "scaling_factor": 0.18215},
    "scheduler": DIT["scheduler"],
}


def test_specs_are_dit_xl2_and_the_vae():
    specs = dit.specs(DIT)
    count = {part: sum(torch.Size(shape).numel() for n, shape, _, _ in specs
                       if n.startswith(part + "."))
             for part in ("dit", "vae")}
    assert count == DIT["parameters"] == {"dit": 674_834_720, "vae": 83_653_863}
    kinds = {n: kind for n, _, kind, _ in specs}
    assert kinds["dit.y_embedder.embedding_table.weight"] == "table"
    assert kinds["dit.blocks.0.adaLN_modulation.1.weight"] == "kernel"
    assert kinds["dit.final_layer.linear.bias"] == "bias"
    assert kinds["dit.x_embedder.proj.weight"] == "kernel"


def test_work_is_1049_gflop_a_call_and_d72_attention():
    w = dit.work_transfer(DIT)
    flops, calls = w["denoiser"]
    assert flops == pytest.approx(1049.08e9, rel=5e-3)
    assert flops == pytest.approx(RD.flops_per_forward(DIT["dit"]), rel=1e-9)
    assert calls.attention == {(1024, 16, 72): 28} and calls.group_norm == {}
    # the VAE's work at 512 px is SD's family's at the same resolution
    sd512 = dict(spec.load_json(spec.PACKAGE / "configs" / "sd21_128.json"), resolution=512)
    ws = sd.work_transfer(sd512)
    for part in ("encode", "decode"):
        assert w[part][0] == ws[part][0] and w[part][1].group_norm == ws[part][1].group_norm
    per_transfer = 100 * flops + w["encode"][0] + w["decode"][0]
    assert per_transfer == pytest.approx(108.5e12, rel=5e-3)


def _tiny_cell(**traffic):
    limits = spec.load_json(spec.PACKAGE / "limits" / "dit_xl2_512.ddib.json")
    mix = dict(spec.load_json(spec.PACKAGE / "traffic" / "ddib_b32.json"), batch=4,
               compute_dtype="float32", checked_rows_per_batch=2, num_inference_steps=3,
               **traffic)
    return spec.Cell("tiny.dit.ddib", 1, copy.deepcopy(TINY), mix, limits, [], [])


def test_a_sound_tiny_dit_transfer_is_correct():
    cell = _tiny_cell()
    out = cell.runner().run(cell, cell.family(), SEED, 0.2, False, CPU, lambda: 0.0)
    line = bench_run.result(cell, out, False, CPU)
    assert line["correct"], line["checked"]
    assert set(line["checked"]) == {"encode_gap", "step_gap", "decode_gap"}


def test_a_dit_transfer_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from phendiff_tpu_torch.pipelines import transfer

    def still(denoiser, schedule, x, src, tgt, **kw):
        for _ in range(2 * kw["num_inference_steps"]):
            denoiser(x.float(), torch.zeros(len(x), dtype=torch.long), src)
        return x.float()

    monkeypatch.setattr(transfer, "ddib", still)
    cell = _tiny_cell()
    out = cell.runner().run(cell, cell.family(), SEED, 0.2, False, CPU, lambda: 0.0)
    line = bench_run.result(cell, out, False, CPU)
    assert not line["correct"] and line["checked"]["step_gap"]["value"] > 0.5


def test_the_data_parallel_fine_tune_at_two_ranks_is_correct():
    """Two gloo ranks of one row each against the reference over both rows:
    the all-reduced step is the global batch's."""
    limits = spec.load_json(spec.PACKAGE / "limits" / "sd21_128.finetune.dp4.json")
    cell = tiny.cell("sd", "train", limits, batch=1, mixed_precision="no",
                     reference_rows_per_block=2, pool_batches=2, checked_steps=2)
    cell.traffic.update(runner="train_dp", ranks=2)
    out = cell.runner().run(cell, cell.family(), SEED, 0.1, False, CPU, lambda: 0.0)
    line = bench_run.result(cell, out, False, CPU)
    assert line["correct"], line["checked"]
    assert line["checked"]["grad_gap"]["value"] < 1e-4  # f32 on both sides
    assert out["attempted"] % 2 == 0
