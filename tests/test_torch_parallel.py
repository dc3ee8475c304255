"""The port's data parallelism (``phendiff_tpu_torch/parallel/mesh.py``) on
the CPU, against its own world 1 and the JAX package on a 2-device mesh.

This file is also its own worker script.  A session fixture starts, all at
once, the port's world-1 run (one process, no group) and a world-2 run (two
processes, gloo, ``file://`` rendezvous), each with
``torch.set_num_threads(1)`` and a 300 s limit:

    python tests/test_torch_parallel.py <inputs.pt> <out_dir> <world> <rank> <init_file>

Each process runs every module of the slice on the same inputs and saves
what it saw: the mesh helpers, three train steps of the tiny UNet (global
batch 8, ``adam_epsilon=1e-3`` as in ``tests/test_torch_train.py``, the
JAX step's draws injected), ``Trainer.run`` with a resume, the Evaluator
and the comparison engine.  Each test below is one assertion over those
results.

Tolerances.  Params and EMA: atol 1e-6 (1% of one update at lr 1e-4) against
the port's world 1 and the JAX step on ``make_mesh(jax.devices()[:2])``;
world 2 averages two half-batch gradients where world 1 sums the whole
batch, f32 rounding in another order.  Loss and gradient norm: rtol 1e-5.
Evaluator features: atol 1e-5 (the Inception over 3 rows in place of 6).
Comparison PNGs: one uint8 level (f32 in another order, truncated).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from phendiff_tpu_torch.core.scheduler import SchedulerConfig  # noqa: E402
from phendiff_tpu_torch.data.imagefolder import (  # noqa: E402
    ImageFolderLoader,
    LoaderConfig,
    scan_imagefolder,
)
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.parallel import mesh  # noqa: E402
from phendiff_tpu_torch.train import train_loop as T  # noqa: E402

TINY = dict(  # tests/test_torch_train.py's
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
TINY16 = dict(TINY, sample_size=16)
GLOBAL_BATCH = 8
T_STEPS = 50
PROBA_UNCOND = 0.5
OPT = dict(learning_rate=1e-4, adam_epsilon=1e-3)
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
FEAT_ATOL = 1e-5
CMP_METHODS = ["ddib", "linear_interp_custom_guidance_inverted_start",
               "classifier_free_guidance_forward_start"]
# 5 images a class in batches of 3: batches of 3, 3, 3 and 1, each padded at world 2
CMP_PER_CLASS, CMP_BATCH = 5, 3
EVAL = dict(nb_generated_images=5, eval_batch_size=3, num_inference_steps=2)
METRICS = dict(fid=False, isc=True, kid=True, kid_subset_size=2, kid_subsets=3)
WORKER_TIMEOUT_S = 300
# rank 0's metric pass stalls STALL_S while rank 1 waits: longer than a
# group with SHORT_TIMEOUT_S waits, shorter than the group's own timeout
STALL_S, SHORT_TIMEOUT_S = 3.0, 1.0


# ---------------------------------------------------------------------------
# The worker: every scenario, run by one process of a world of 1 or 2
# ---------------------------------------------------------------------------

def _mesh_scenario():
    x = torch.arange(4 * mesh.data_size(), dtype=torch.float32).reshape(-1, 1)
    mine = torch.full((3,), float(mesh.data_rank() + 1))
    return {
        "size": mesh.data_size(), "rank": mesh.data_rank(), "main": mesh.is_main(),
        "layout": mesh.make_mesh(),
        "rows": mesh.shard_batch({"x": x})["x"],
        "gathered": mesh.all_gather_rows(mesh.shard_batch(x)),
        "replicated": mesh.replicate({"t": mine})["t"],
        "cycle": mesh.padded_rows(5, "cycle"), "repeat_last": mesh.padded_rows(5, "repeat_last"),
    }


def _train_scenario(inputs):
    from torch.func import functional_call

    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    with torch.device("meta"):
        model = CondUNet2D(UNet2DConfig(**TINY))
    cfg = T.TrainConfig(proba_uncond=PROBA_UNCOND, optimizer=T.OptimizerConfig(**OPT))
    opt = T.make_optimizer(cfg.optimizer)
    step = T.make_train_step(
        lambda p, x, t, ce: functional_call(model, p, (x, t), {"class_emb": ce}),
        lambda p, lab: p["class_embedding.weight"][lab],
        S.make_schedule(S.SchedulerConfig(num_train_timesteps=T_STEPS), device="cpu"), cfg, opt)
    params = {n: v.clone().requires_grad_() for n, v in inputs["params"].items()}
    state = T.init_train_state(params, opt)
    batch = mesh.shard_batch((torch.from_numpy(inputs["images"]),
                              torch.from_numpy(inputs["labels"]).long()))
    rows = mesh.local_rows(GLOBAL_BATCH)
    out = {"loss": [], "grad_norm": []}
    for i, d in enumerate(inputs["draws"]):
        state, m = step(state, batch, T.StepDraws(**d).rows(rows))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i in (0, 2):
            out[f"params_{i + 1}"] = {n: p.detach().clone() for n, p in state.params.items()}
            out[f"ema_{i + 1}"] = {n: p.clone() for n, p in state.ema_params.items()}
    return out


def _tiny_trainer(data, root, run, **overrides):
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    pipe = ConditionalDDIMPipeline.init_random(
        UNet2DConfig(**TINY16), SchedulerConfig(num_train_timesteps=20, clip_sample=False),
        seed=0, device="cpu")
    kw = dict(train_data_dir=data, definition=(16, 16), train_batch_size=GLOBAL_BATCH,
              num_epochs=1, eval_every_epochs=1, checkpointing_steps=2, mixed_precision="no",
              compute_metrics=False,
              train=T.TrainConfig(proba_uncond=0.1,
                                  optimizer=T.OptimizerConfig(learning_rate=1e-3)))
    kw.update(overrides)
    paths = RunPaths.create(root, "exp", run)
    return for_ddim_pipeline(pipe, TrainerConfig(**kw), paths)


def _trainer_scenario(data, root):
    from phendiff_tpu_torch.train.checkpoints import CheckpointManager

    writes = {"checkpoints": 0, "pipelines": 0}
    write = CheckpointManager._write

    def counted(self, *args):
        writes["checkpoints"] += 1
        return write(self, *args)

    CheckpointManager._write = counted
    try:
        trainer = _tiny_trainer(data, root, "run0")
        save = trainer.save_pipeline_fn

        def counted_save(*args):
            writes["pipelines"] += 1
            return save(*args)

        trainer.save_pipeline_fn = counted_save
        first = trainer.run()
        resumed = _tiny_trainer(data, root, "run0", num_epochs=2, resume_from_checkpoint="latest")
        start = resumed.maybe_resume()
        end = resumed.run()
    finally:
        CheckpointManager._write = write
    return {
        "lr_scale": trainer.train_cfg.optimizer.lr_scale, "tracker": type(trainer.tracker).__name__,
        "loader_batch": trainer.loader.config.batch_size, "loader_len": len(trainer.loader),
        "shard_index": trainer.loader.config.shard_index, "writes": writes,
        "first_steps": first.step, "resume_start": start, "final_steps": end.step,
        "final_params": {n: p.detach().clone() for n, p in end.params.items()},
    }


def _evaluator_scenario(data, root):
    from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
    from phendiff_tpu_torch.train.eval_loop import EvalConfig, Evaluator

    trainer = _tiny_trainer(data, root, "eval")
    generate = trainer.make_generate_fn(trainer.state)
    ev = Evaluator(EvalConfig(metrics=MetricsConfig(**METRICS), **EVAL), scan_imagefolder(data),
                   (16, 16), device="cpu")
    classes = [ev._generate_class(generate, c) for c in range(2)]
    return {"features": [c[0] for c in classes], "logits": [c[1] for c in classes],
            "panels": [c[2] for c in classes], "metrics": ev.evaluate(generate, 0)}


def _comparison_scenario(inputs, out_dir):
    from phendiff_tpu_torch.experiments import comparison

    cfg = comparison.ComparisonConfig.from_dict(_cmp_conf(inputs, out_dir))
    return comparison.ComparisonExperiment(cfg, device="cpu").run()


def _cmp_conf(inputs, out_dir):
    return {
        "output_dir": out_dir, "pipelines": {"ddim": inputs["cmp_pipe"]},
        "dataset_train": inputs["cmp_data"], "definition": [16, 16], "methods": CMP_METHODS,
        "method_params": {m: {"batch_size": CMP_BATCH, "guidance_loss_scale": 1e-2}
                          for m in CMP_METHODS},
        "num_inference_steps": 2, "metrics": METRICS, "inference_param_dtype": None,
    }


def _stall_scenario():
    """Rank 0's comparison metric pass stalls ``STALL_S`` while rank 1
    waits for it: first in a group whose timeout is ``SHORT_TIMEOUT_S``
    (the wait fails), then in ``compute_metrics``, in the group
    ``init_distributed`` made (it gets rank 0's metrics)."""
    import datetime
    import time
    import types

    import torch.distributed as dist

    from phendiff_tpu_torch.experiments.comparison import ComparisonExperiment

    short = dist.new_group(timeout=datetime.timedelta(seconds=SHORT_TIMEOUT_S))
    backend = dist.distributed_c10d._get_default_group()._get_backend(torch.device("cpu"))
    out = {"timeout_s": backend.options._timeout.total_seconds(), "short": None}
    t0 = time.perf_counter()
    if not mesh.is_main():
        try:
            dist.broadcast(torch.zeros(1), src=0, group=short)
        except RuntimeError as e:
            out["short"] = type(e).__name__

    def metrics():
        time.sleep(STALL_S)
        return {"fid": 1.0}

    out["metrics"] = ComparisonExperiment.compute_metrics(types.SimpleNamespace(_metrics=metrics))
    out["waited_s"] = time.perf_counter() - t0
    return out


def worker(argv):
    inputs_path, out_dir, world, rank, init_file = argv
    os.environ["PHENDIFF_INCEPTION_RESIZE"] = "75"
    torch.set_num_threads(1)
    tag = f"w{world}"
    if int(world) > 1:
        os.environ.update(WORLD_SIZE=world, RANK=rank, LOCAL_RANK="0")
        mesh.init_distributed("cpu", init_method=f"file://{init_file}")
    inputs = torch.load(inputs_path, weights_only=False)
    root = os.path.join(out_dir, tag)
    os.makedirs(root, exist_ok=True)
    result = {
        "mesh": _mesh_scenario(),
        "train": _train_scenario(inputs),
        "trainer": _trainer_scenario(inputs["data"], root),
        "evaluator": _evaluator_scenario(inputs["data"], root),
        "comparison": _comparison_scenario(inputs, os.path.join(root, "cmp")),
        "stall": _stall_scenario() if int(world) > 1 else None,
    }
    torch.save(result, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    mesh.destroy()


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests (pytest process: JAX on 8 virtual CPU devices, conftest.py)
# ---------------------------------------------------------------------------

def _flax_params():
    import jax
    import jax.numpy as jnp

    from phendiff_tpu.models import CondUNet2D as JaxUNet
    from phendiff_tpu.models import UNet2DConfig as JaxConfig

    model = JaxUNet(JaxConfig(**TINY), lane_pack=False)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.array([0]),
                        class_labels=jnp.array([0]))
    return model, params


def _to_torch(tree):
    from phendiff_tpu.pipelines.io import flatten_params
    from phendiff_tpu_torch.models import convert

    return convert.from_flax_params(flatten_params(tree), UNet2DConfig(**TINY))


def _jax_draws(key, step, shape):
    """The JAX step's draws (tests/test_torch_train.py): fold_in(key, step)
    -> (flip, enc, loss); loss -> (noise, t)."""
    import jax
    import jax.numpy as jnp

    k_flip, _, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)
    k_noise, k_t = jax.random.split(k_loss)
    return dict(
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (shape[0],), 0, T_STEPS))),
        uncond=bool(jax.random.bernoulli(k_flip, PROBA_UNCOND)),
    )


def _write_cmp_inputs(root):
    import dataclasses

    from PIL import Image

    from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
    from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig
    from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline

    sched = JaxSchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                               clip_sample=False)
    pipe = JaxPipeline.init_random(JaxUNetConfig(**TINY16), sched, seed=2)
    dataclasses.replace(pipe, lane_pack=False).save_pretrained(os.path.join(root, "pipe"))
    rng = np.random.default_rng(0)
    for cls in ("DMSO", "drug"):
        os.makedirs(os.path.join(root, "data", cls))
        for i in range(CMP_PER_CLASS):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                os.path.join(root, "data", cls, f"img_{i}.png"))
    return os.path.join(root, "pipe"), os.path.join(root, "data")


@pytest.fixture(scope="session")
def runs(tmp_path_factory, tiny_image_root):
    """Inputs written once; the world-1 and world-2 runs started together;
    the JAX references computed while they run."""
    import jax
    import jax.numpy as jnp

    from phendiff_tpu.parallel import make_mesh as jax_make_mesh
    from phendiff_tpu.parallel import replicate as jax_replicate
    from phendiff_tpu.parallel import shard_batch as jax_shard_batch
    from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
    from phendiff_tpu.core import make_schedule as jax_make_schedule
    from phendiff_tpu.train import train_loop as JT

    root = str(tmp_path_factory.mktemp("parallel"))
    jmodel, params = _flax_params()
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (GLOBAL_BATCH, 8, 8, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1], dtype=np.int32)
    key = jax.random.key(7)
    cmp_pipe, cmp_data = _write_cmp_inputs(root)
    inputs = {"params": _to_torch(params), "images": images, "labels": labels,
              "draws": [_jax_draws(key, s, images.shape) for s in range(3)],
              "data": str(tiny_image_root), "cmp_pipe": cmp_pipe, "cmp_data": cmp_data}
    inputs_path = os.path.join(root, "inputs.pt")
    torch.save(inputs, inputs_path)

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    init_file = os.path.join(root, "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), inputs_path, root, str(world), str(rank),
         init_file], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for world, rank in ((1, 0), (2, 0), (2, 1))]

    # the JAX step with the batch sharded over a 2-device mesh, while they run
    jcfg = JT.TrainConfig(proba_uncond=PROBA_UNCOND, optimizer=JT.OptimizerConfig(**OPT))
    jopt = JT.make_optimizer(jcfg.optimizer)
    jstep = jax.jit(JT.make_train_step(
        lambda p, x, t, ce: jmodel.apply(p, x, t, class_emb=ce),
        lambda p, lab: p["params"]["class_embedding"]["embedding"][lab],
        jax_make_schedule(JaxSchedulerConfig(num_train_timesteps=T_STEPS)), jcfg, jopt))
    jmesh = jax_make_mesh(jax.devices()[:2])
    jstate = jax_replicate(jmesh, JT.init_train_state(params, jopt))
    jbatch = jax_shard_batch(jmesh, (jnp.asarray(images), jnp.asarray(labels)))
    jax_train = {"loss": [], "grad_norm": []}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, key)
        jax_train["loss"].append(float(jm["loss"]))
        jax_train["grad_norm"].append(float(jm["grad_norm"]))
        if i in (0, 2):
            jax_train[f"params_{i + 1}"] = _to_torch(jstate.params)
            jax_train[f"ema_{i + 1}"] = _to_torch(jstate.ema_params)

    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
        assert p.returncode == 0, "\n".join(logs)[-6000:]
    got = {tag: torch.load(os.path.join(root, f"{tag}.pt"), weights_only=False)
           for tag in ("w1_rank0", "w2_rank0", "w2_rank1")}
    return {"root": root, "inputs": inputs, "jax_train": jax_train, **got}


def _assert_params_close(got, want, what):
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")


# -- loaders: the JAX loaders' shards, batch for batch ------------------------

@pytest.mark.parametrize("shard_index", [0, 1])
def test_image_folder_shards_match_the_jax_loader(tiny_image_root, monkeypatch, shard_index):
    from phendiff_tpu.data import imagefolder as jax_imagefolder
    from phendiff_tpu.data import native as jax_native
    from phendiff_tpu_torch.data import native

    monkeypatch.setattr(jax_native, "get_lib", native.get_lib)  # one native build for both
    cfg = dict(batch_size=3, definition=(12, 10), random_flip=True, seed=4, num_shards=2,
               shard_index=shard_index)
    loader = ImageFolderLoader(scan_imagefolder(tiny_image_root), LoaderConfig(**cfg))
    jloader = jax_imagefolder.ImageFolderLoader(
        jax_imagefolder.scan_imagefolder(tiny_image_root), jax_imagefolder.LoaderConfig(**cfg))
    assert len(loader) == len(jloader) == 5  # 32 images, 16 a shard, batches of 3
    for epoch in (0, 1):
        got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
        assert len(got) == len(want) == 5
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("shard_index", [0, 1])
def test_hf_adapter_shards_match_the_jax_adapter(tiny_image_root, shard_index):
    from phendiff_tpu.data import hf_datasets as jax_hf
    from phendiff_tpu.data.imagefolder import LoaderConfig as JaxLoaderConfig
    from phendiff_tpu_torch.data import hf_datasets

    cfg = dict(batch_size=3, definition=(16, 16), seed=5, random_flip=True, num_shards=2,
               shard_index=shard_index)
    port = hf_datasets.load_hf_dataset(str(tiny_image_root), LoaderConfig(**cfg))
    ref = jax_hf.load_hf_dataset(str(tiny_image_root), JaxLoaderConfig(**cfg))
    assert len(port) == len(ref) == 5
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 5
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gi, wi)


# -- the mesh helpers ----------------------------------------------------------

def test_shard_batch_replicate_and_gather_at_world_2(runs):
    for rank in (0, 1):
        m = runs[f"w2_rank{rank}"]["mesh"]
        assert (m["size"], m["rank"], m["main"]) == (2, rank, rank == 0)
        # contiguous, rank-major rows, as jax.make_array_from_process_local_data assembles
        assert m["layout"] == {mesh.DATA_AXIS: 2, mesh.MODEL_AXIS: 1}
        np.testing.assert_array_equal(m["rows"].numpy().ravel(), np.arange(4 * rank, 4 * rank + 4))
        np.testing.assert_array_equal(m["gathered"].numpy().ravel(), np.arange(8))
        np.testing.assert_array_equal(m["replicated"].numpy(), [1.0, 1.0, 1.0])
        np.testing.assert_array_equal(m["cycle"], [[0, 1, 2], [3, 4, 0]][rank])
        np.testing.assert_array_equal(m["repeat_last"], [[0, 1, 2], [3, 4, 4]][rank])
    one = runs["w1_rank0"]["mesh"]
    assert (one["size"], one["rank"], one["main"]) == (1, 0, True)
    np.testing.assert_array_equal(one["cycle"], np.arange(5))


def test_make_mesh_names_the_layout_and_checks_divisibility():
    assert mesh.make_mesh() == {mesh.DATA_AXIS: 1, mesh.MODEL_AXIS: 1}
    assert (mesh.DATA_AXIS, mesh.MODEL_AXIS) == ("data", "model")
    # one process: a model axis of 2 does not divide it, as JAX's make_mesh refuses
    for bad in (2, 0):
        with pytest.raises(ValueError, match=f"not divisible by model_parallel={bad}"):
            mesh.make_mesh(model_parallel=bad)
    assert (mesh.model_size(), mesh.model_rank(), mesh.data_size(), mesh.data_rank()) == (1, 0, 1, 0)


def test_init_distributed_raises_without_a_reachable_group(monkeypatch, tmp_path):
    import datetime

    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.init_distributed("cpu")
    # a rendezvous the second rank never joins: an error, never world 1
    with pytest.raises(RuntimeError):
        mesh.init_distributed("cpu", init_method=f"file://{tmp_path / 'alone'}",
                              timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized() and mesh.data_size() == 1
    monkeypatch.delenv("WORLD_SIZE")
    assert mesh.init_distributed("cpu") == torch.device("cpu")  # no environment: a no-op
    assert not dist.is_initialized()


def test_ranks_wait_out_rank_0s_metric_pass_in_the_group_init_distributed_made(runs):
    import datetime

    # above NCCL's 10-minute default, which a long host FID pass outlasts
    assert mesh.GROUP_TIMEOUT >= datetime.timedelta(hours=1)
    for rank in (0, 1):
        s = runs[f"w2_rank{rank}"]["stall"]
        assert s["timeout_s"] == mesh.GROUP_TIMEOUT.total_seconds()
        assert s["metrics"] == {"fid": 1.0}
    waiting = runs["w2_rank1"]["stall"]
    assert waiting["short"] == "RuntimeError"  # the short group gave up on rank 0
    assert waiting["waited_s"] > 2 * SHORT_TIMEOUT_S  # well past the short group's limit


def test_the_batch_gap_witness_runs_on_the_cpu(monkeypatch):
    from phendiff_tpu_torch.tools import ddib_batch_gap as W

    monkeypatch.setattr(W, "super_small", lambda: UNet2DConfig(**TINY16))
    monkeypatch.setattr(W, "RES", 16)
    rec = W.witness(torch.device("cpu"), W.first_batch(), 2)
    assert rec["rows"] == [2, 4] and rec["call"]["t"] == -1  # DDIB's first inversion row
    for key in ("batch", "ulp"):
        assert len(rec[key]["per_call_max_abs"]) == 2 * W.STEPS
        assert math.isfinite(rec[key]["output_max_abs_01"])
    # the nudge is one ulp of [-1, 1] pixels at the first call
    assert 0 < rec["ulp"]["per_call_max_abs"][0] <= 2.0 ** -23


def test_step_draws_rows_and_rows_of_a_generator_are_the_whole_batchs():
    from phendiff_tpu_torch.core.rng import RowsOf
    from phendiff_tpu_torch.pipelines.conditional_ddim import _randn

    d = T.make_draws(3, 1, (6, 4, 4, 3), T_STEPS, 0.5, "cpu", posterior=True)
    part = d.rows(slice(3, 6))
    assert torch.equal(part.noise, d.noise[3:]) and torch.equal(part.enc_noise, d.enc_noise[3:])
    assert torch.equal(part.timesteps, d.timesteps[3:]) and part.uncond == d.uncond
    rows = torch.tensor([3, 4, 0])
    full = _randn((5, 4, 4, 3), torch.Generator().manual_seed(9), "cpu")
    got = _randn((3, 4, 4, 3), RowsOf(torch.Generator().manual_seed(9), 5, rows), "cpu")
    assert torch.equal(got, full[rows])
    with pytest.raises(ValueError, match="rows"):
        _randn((2, 4, 4, 3), RowsOf(torch.Generator(), 5, rows), "cpu")


# -- the train step --------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
def test_world_2_steps_match_world_1_and_the_jax_step_on_a_2_device_mesh(runs, steps):
    one, jax_train = runs["w1_rank0"]["train"], runs["jax_train"]
    for rank in (0, 1):
        two = runs[f"w2_rank{rank}"]["train"]
        for key in ("loss", "grad_norm"):  # the global loss and gradient on every rank
            np.testing.assert_allclose(two[key][:steps], one[key][:steps], rtol=LOSS_RTOL)
            np.testing.assert_allclose(two[key][:steps], jax_train[key][:steps], rtol=LOSS_RTOL)
        for what in ("params", "ema"):
            got = two[f"{what}_{steps}"]
            _assert_params_close(got, one[f"{what}_{steps}"], f"{what} vs world 1, rank {rank}")
            _assert_params_close(got, jax_train[f"{what}_{steps}"],
                                 f"{what} vs JAX, rank {rank}")


def test_world_2_replicas_stay_bit_equal(runs):
    a, b = runs["w2_rank0"], runs["w2_rank1"]
    for what in ("params_3", "ema_3"):
        for n, t in a["train"][what].items():
            assert torch.equal(t, b["train"][what][n]), n
    for n, t in a["trainer"]["final_params"].items():
        assert torch.equal(t, b["trainer"]["final_params"][n]), n


# -- the Trainer --------------------------------------------------------------------

def test_trainer_lr_scale_is_sqrt_of_the_data_size_as_in_the_jax_trainer(runs, tmp_path):
    import jax

    from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
    from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig
    from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline
    from phendiff_tpu.train import trainer as JTr
    from phendiff_tpu.train.train_loop import TrainConfig as JaxTrainConfig

    pipe = JaxPipeline.init_random(JaxUNetConfig(**TINY16), JaxSchedulerConfig(), seed=0)
    jcfg = JTr.TrainerConfig(train_data_dir=runs["inputs"]["data"], definition=(16, 16),
                             train_batch_size=GLOBAL_BATCH, compute_metrics=False,
                             train=JaxTrainConfig())
    paths = JTr.RunPaths.create(str(tmp_path), "exp", "jax")
    want = JTr.for_ddim_pipeline(pipe, jcfg, paths, devices=jax.devices()[:2])
    assert want.train_cfg.optimizer.lr_scale == math.sqrt(2)
    for rank in (0, 1):
        assert runs[f"w2_rank{rank}"]["trainer"]["lr_scale"] == math.sqrt(2)
    assert runs["w1_rank0"]["trainer"]["lr_scale"] == 1.0


def test_trainer_at_world_2_shards_the_loader_and_only_rank_0_writes(runs):
    for rank in (0, 1):
        t = runs[f"w2_rank{rank}"]["trainer"]
        # 32 images: 16 a shard, batches of 8 // 2 = 4
        assert (t["loader_batch"], t["loader_len"], t["shard_index"]) == (4, 4, rank)
        assert t["tracker"] == ("JSONLTracker" if rank == 0 else "NullTracker")
        # steps 2, 4, the final 4, then 6, 8, the final 8
        assert t["writes"] == ({"checkpoints": 6, "pipelines": 1} if rank == 0
                               else {"checkpoints": 0, "pipelines": 0})
    run_dir = os.path.join(runs["root"], "w2", "exp", "run0")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == list(range(1, 9))  # one record a step: rank 0's
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["2", "4", "6", "8"]
    assert os.path.isfile(os.path.join(run_dir, "full_pipeline_save", "model_index.json"))


def test_trainer_resumes_at_world_2_on_every_rank(runs):
    for rank in (0, 1):
        t = runs[f"w2_rank{rank}"]["trainer"]
        assert t["first_steps"] == 4 and t["final_steps"] == 8
        assert tuple(t["resume_start"]) == (1, 0)  # epoch 1, nothing to skip


# -- the Evaluator ------------------------------------------------------------------

@pytest.mark.parametrize("label", [0, 1])
def test_evaluator_world_2_features_equal_world_1(runs, label):
    one = runs["w1_rank0"]["evaluator"]
    for rank in (0, 1):
        two = runs[f"w2_rank{rank}"]["evaluator"]
        for key in ("features", "logits"):
            assert two[key][label].shape == one[key][label].shape
            assert one[key][label].shape[0] == EVAL["nb_generated_images"]
            np.testing.assert_allclose(two[key][label], one[key][label], rtol=0, atol=FEAT_ATOL)
        assert two["panels"][label].shape == one["panels"][label].shape  # trimmed to 3 rows
        np.testing.assert_allclose(two["panels"][label], one["panels"][label], atol=FEAT_ATOL)


def test_evaluator_world_2_metrics_equal_on_both_ranks(runs):
    m0 = runs["w2_rank0"]["evaluator"]["metrics"]
    assert m0 == runs["w2_rank1"]["evaluator"]["metrics"]
    assert "DMSO/kernel_inception_distance_mean" in m0
    one = runs["w1_rank0"]["evaluator"]["metrics"]
    assert m0.keys() == one.keys()
    for k, v in one.items():
        np.testing.assert_allclose(m0[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# -- the comparison engine -------------------------------------------------------

def _pngs(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files if f.endswith(".png"))


def _assert_same_pngs(got_dir, want_dir, prefixes):
    from PIL import Image

    names = [f for f in _pngs(want_dir) if f.startswith(prefixes)]
    assert names and [f for f in _pngs(got_dir) if f.startswith(prefixes)] == names
    for f in names:
        a = np.asarray(Image.open(os.path.join(got_dir, f)), dtype=np.int16)
        b = np.asarray(Image.open(os.path.join(want_dir, f)), dtype=np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, f


def test_comparison_world_2_equals_world_1_padded_rows_trimmed(runs):
    one, two = (os.path.join(runs["root"], w, "cmp") for w in ("w1", "w2"))
    _assert_same_pngs(two, one, tuple(CMP_METHODS))
    n = len([f for f in _pngs(two) if "_to_" in f])
    assert n == len(CMP_METHODS) * 2 * CMP_PER_CLASS  # no padded row became a PNG
    with open(os.path.join(two, "timings.json")) as f:
        assert all(t["images"] == 2 * CMP_PER_CLASS for t in json.load(f).values())
    with open(os.path.join(two, "metrics.json")) as f:
        written = json.load(f)
    assert written == runs["w2_rank0"]["comparison"] == runs["w2_rank1"]["comparison"]
    assert written.keys() == runs["w1_rank0"]["comparison"].keys()


def test_comparison_world_2_equals_the_jax_engine_on_2_devices(runs, monkeypatch, tmp_path):
    import types

    import jax
    import yaml

    from phendiff_tpu.experiments import comparison as jax_comparison

    # transfers only: the Inception and its metrics are held by the test above
    monkeypatch.setattr(jax_comparison, "InceptionExtractor",
                        lambda: types.SimpleNamespace(pretrained=True))
    conf = dict(_cmp_conf(runs["inputs"], str(tmp_path / "jax")), methods=["ddib"])
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    jexp = jax_comparison.ComparisonExperiment(
        jax_comparison.ComparisonConfig.from_yaml(str(tmp_path / "conf.yaml")),
        devices=jax.devices()[:2])
    jexp.run_transfers()
    _assert_same_pngs(os.path.join(runs["root"], "w2", "cmp"), str(tmp_path / "jax"), ("ddib/",))


# -- the launcher and the CLIs ------------------------------------------------------

def test_launcher_prefixes_torchrun_with_more_than_one_visible_card(monkeypatch):
    from phendiff_tpu_torch.cli import launcher

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cmd = launcher.build_command("c.yaml", ["k=v"], debug=False)
    assert cmd[:5] == [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node=4"]
    assert cmd[5:] == ["-m", "phendiff_tpu_torch.cli.img2img_cli", "--config", "c.yaml",
                       "--override", "k=v"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert launcher.build_command("c.yaml", [], debug=False)[1:3] == [
        "-m", "phendiff_tpu_torch.cli.img2img_cli"]


def test_clis_join_the_group_only_under_torchrun(monkeypatch):
    from phendiff_tpu_torch.cli import args as A

    joined = []
    monkeypatch.setattr(A, "init_distributed", lambda d: joined.append(d) or torch.device("cpu"))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert A.process_device("cpu") == torch.device("cpu") and joined == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert A.process_device("cpu") == torch.device("cpu") and joined == ["cpu"]
