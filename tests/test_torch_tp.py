"""The port's tensor parallelism (``phendiff_tpu_torch/parallel/tp.py``) on
the CPU, against its own world 1 and the JAX package on a (1, 2) mesh.

This file is also its own worker script.  A session fixture starts, all at
once, a 1 x 2 world (two processes: one replica, two model ranks) and a
2 x 2 world (four processes), gloo with ``file://`` rendezvous, each
process with ``torch.set_num_threads(1)`` and a 300 s limit:

    python tests/test_torch_tp.py <inputs.pt> <out_dir> <world> <rank> <init_file>

Each process lays out ``make_mesh(2)`` and runs, on the same inputs: the
mesh helpers, a forward of both families (``tests/test_tp.py``'s
``TINY_ATTN`` and ``TINY_SD``), three train steps of ``TINY_ATTN`` (global
batch 8, ``adam_epsilon=1e-3``, the JAX step's draws injected) and, at
1 x 2, ``Trainer.run`` with a checkpoint and a resume, with f32 and with
bf16 first moments.  The world-1
results are the same scenarios run in the pytest process without a group,
and JAX computes its forwards and steps on ``make_mesh(jax.devices()[:2],
model_parallel=2)`` meanwhile.

Tolerances.  Forwards: 1e-5 (f32; a row-parallel layer sums two partial
products where world 1 sums one).  Params and EMA: atol 1e-6 (1% of one
update at lr 1e-4); loss and gradient norm rtol 1e-5.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.models.sd_unet import SDUNetConfig  # noqa: E402
from phendiff_tpu_torch.parallel import mesh, tp  # noqa: E402
from phendiff_tpu_torch.train import train_loop as T  # noqa: E402

TINY_ATTN = dict(  # tests/test_tp.py's
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
TINY_SD = dict(  # tests/test_tp.py's
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=24, attention_head_dim=(2, 4), norm_num_groups=4,
)
MP = 2
GLOBAL_BATCH, FWD_BATCH = 8, 4
T_STEPS = 50
PROBA_UNCOND = 0.5
OPT = dict(learning_rate=1e-4, adam_epsilon=1e-3)
FWD_TOL = 1e-5
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
WORKER_TIMEOUT_S = 300
WORLDS = ((2, "w2"), (4, "w4"))  # 1 x 2 and 2 x 2


# ---------------------------------------------------------------------------
# The scenarios: run by each worker process at model size 2, and by the
# pytest process at world 1 (model size 1, no group)
# ---------------------------------------------------------------------------

def _snapshot(params):
    """A copy: the gathered tree shares its replicated leaves with the state."""
    return {n: t.detach().clone() for n, t in params.items()}


def _mesh_scenario(mp):
    layout = mesh.make_mesh(mp)
    x = torch.arange(4 * mesh.data_size(), dtype=torch.float32).reshape(-1, 1)
    return {
        "layout": layout, "data": (mesh.data_size(), mesh.data_rank()),
        "model": (mesh.model_size(), mesh.model_rank()), "main": mesh.is_main(),
        "rows": mesh.shard_batch(x), "gathered": mesh.all_gather_rows(mesh.shard_batch(x)),
    }


def _forward_scenario(inputs, mp):
    from torch.func import functional_call

    from phendiff_tpu_torch.models.sd_unet import SDUNet
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    mesh.make_mesh(mp)
    out = {}
    with torch.device("meta"):
        ddim, sd = CondUNet2D(UNet2DConfig(**TINY_ATTN)), SDUNet(SDUNetConfig(**TINY_SD))
        ddim16 = CondUNet2D(UNet2DConfig(**TINY_ATTN), dtype=torch.bfloat16)
    for name, model, params, args in (
            ("ddim", ddim, inputs["params"], ("x", "t")),
            ("ddim_bf16", ddim16, inputs["params"], ("x", "t")),
            ("sd", sd, inputs["sd_params"], ("sd_x", "sd_t", "sd_ctx"))):
        plan = tp.shard_module(model)
        local = tp.shard_params(params, plan)
        a = mesh.shard_batch(tuple(torch.from_numpy(inputs[k]) for k in args))
        kw = ({"class_labels": mesh.shard_batch(torch.from_numpy(inputs["y"]))}
              if name.startswith("ddim") else {})
        with torch.no_grad():
            out[name] = functional_call(model, local, a, kw)
        out[f"{name}_plan"] = plan
    return out


def _train_scenario(inputs, mp):
    from torch.func import functional_call

    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    mesh.make_mesh(mp)
    with torch.device("meta"):
        model = CondUNet2D(UNet2DConfig(**TINY_ATTN))
    plan = tp.shard_module(model)
    cfg = T.TrainConfig(proba_uncond=PROBA_UNCOND, optimizer=T.OptimizerConfig(**OPT))
    opt = T.make_optimizer(cfg.optimizer, sharded=plan)
    step = T.make_train_step(
        lambda p, x, t, ce: functional_call(model, p, (x, t), {"class_emb": ce}),
        lambda p, lab: p["class_embedding.weight"][lab],
        S.make_schedule(S.SchedulerConfig(num_train_timesteps=T_STEPS), device="cpu"), cfg, opt)
    params = {n: v.clone().requires_grad_() for n, v in inputs["params"].items()}
    full = T.init_train_state(params, opt)
    state = T.TrainState(step=0, params=tp.shard_params(full.params, plan),
                         ema_params=tp.shard_params(full.ema_params, plan),
                         opt_state=opt.init(tp.shard_params(full.params, plan)))
    batch = mesh.shard_batch((torch.from_numpy(inputs["images"]),
                              torch.from_numpy(inputs["labels"]).long()))
    rows = mesh.local_rows(GLOBAL_BATCH)
    out = {"loss": [], "grad_norm": [], "plan": plan}
    for i, d in enumerate(inputs["draws"]):
        state, m = step(state, batch, T.StepDraws(**d).rows(rows))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i in (0, 2):
            out[f"params_{i + 1}"] = _snapshot(tp.gather_params(state.params, plan))
            out[f"ema_{i + 1}"] = _snapshot(tp.gather_params(state.ema_params, plan))
    out["local"] = {n: p.detach().clone() for n, p in state.params.items()}
    return out


def _trainer(data, root, run, mp, **overrides):
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.train.trainer import RunPaths, TrainerConfig, for_ddim_pipeline

    pipe = ConditionalDDIMPipeline.init_random(
        UNet2DConfig(**dict(TINY_ATTN, sample_size=16)),
        SchedulerConfig(num_train_timesteps=20, clip_sample=False), seed=0, device="cpu")
    kw = dict(train_data_dir=data, definition=(16, 16), train_batch_size=GLOBAL_BATCH,
              num_epochs=1, eval_every_epochs=1, checkpointing_steps=2, mixed_precision="no",
              compute_metrics=False, model_parallel=mp,
              train=T.TrainConfig(proba_uncond=0.1, optimizer=T.OptimizerConfig(**OPT)))
    kw.update(overrides)
    return for_ddim_pipeline(pipe, TrainerConfig(**kw), RunPaths.create(root, "exp", run))


def _trainer_scenario(data, root, mp, run_it):
    import json

    trainer = _trainer(data, root, "run0", mp)
    out = {"loader_batch": trainer.loader.config.batch_size,
           "shard_index": trainer.loader.config.shard_index,
           "num_shards": trainer.loader.config.num_shards,
           "lr_scale": trainer.train_cfg.optimizer.lr_scale}
    if not run_it:
        return out
    first = trainer.run()
    out["first_steps"] = first.step
    out["first_params"] = _snapshot(trainer.full_state().params)
    resumed = _trainer(data, root, "run0", mp, num_epochs=2, resume_from_checkpoint="latest")
    out["resume_start"] = resumed.maybe_resume()
    out["resumed_params"] = _snapshot(resumed.full_state().params)
    end = resumed.run()
    out["final_steps"] = end.step
    out["final_params"] = _snapshot(resumed.full_state().params)
    if mesh.is_main():
        with open(os.path.join(root, "exp", "run0", "metrics.jsonl")) as f:
            out["losses"] = [json.loads(line)["loss"] for line in f]
    return out


def _full_state_snapshot(trainer):
    full = trainer.full_state()
    return {"params": _snapshot(full.params), "mu": _snapshot(full.opt_state.mu),
            "nu": _snapshot(full.opt_state.nu), "count": full.opt_state.count}


def _bf16_moment_trainer_scenario(data, root, mp):
    """``Trainer.run`` with Adam's first moment in bf16: the checkpoint
    gathers the bf16 moments over the model group, and a resume cuts them
    again; the full state before and after, and each rank's moment dtypes."""
    opt = dict(train=T.TrainConfig(proba_uncond=0.1, optimizer=T.OptimizerConfig(
        **OPT, moment_dtype="bfloat16")))
    trainer = _trainer(data, root, "bf16", mp, **opt)
    trainer.run()
    out = {"saved": _full_state_snapshot(trainer),
           "local_mu_dtypes": {str(t.dtype) for t in trainer.state.opt_state.mu.values()},
           "local_nu_dtypes": {str(t.dtype) for t in trainer.state.opt_state.nu.values()}}
    resumed = _trainer(data, root, "bf16", mp, num_epochs=2, resume_from_checkpoint="latest",
                       **opt)
    out["resume_start"] = resumed.maybe_resume()
    out["resumed"] = _full_state_snapshot(resumed)
    out["resumed_local_mu_dtypes"] = {str(t.dtype)
                                      for t in resumed.state.opt_state.mu.values()}
    out["final_steps"] = resumed.run().step
    return out


def worker(argv):
    inputs_path, out_dir, world, rank, init_file = argv
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=world, RANK=rank, LOCAL_RANK="0")
    mesh.init_distributed("cpu", init_method=f"file://{init_file}")
    inputs = torch.load(inputs_path, weights_only=False)
    tag = f"w{world}"
    root = os.path.join(out_dir, tag)
    os.makedirs(root, exist_ok=True)
    result = {
        "mesh": _mesh_scenario(MP),
        "forward": _forward_scenario(inputs, MP),
        "train": _train_scenario(inputs, MP),
        "trainer": _trainer_scenario(inputs["data"], root, MP, run_it=world == "2"),
    }
    if world == "2":
        result["bf16_trainer"] = _bf16_moment_trainer_scenario(inputs["data"], root, MP)
    torch.save(result, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))
    mesh.destroy()


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests (pytest process: JAX on 8 virtual CPU devices, conftest.py)
# ---------------------------------------------------------------------------

def _jax_models():
    from phendiff_tpu.models import CondUNet2D as JaxUNet
    from phendiff_tpu.models import UNet2DConfig as JaxConfig
    from phendiff_tpu.models.sd_unet import SDUNet as JaxSDUNet
    from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig

    return (JaxUNet(JaxConfig(**TINY_ATTN), lane_pack=False),
            JaxSDUNet(JaxSDConfig(**TINY_SD)))


def _to_torch(tree, cfg):
    from phendiff_tpu.pipelines.io import flatten_params
    from phendiff_tpu_torch.models import convert

    return convert.from_flax_params(flatten_params(tree), cfg)


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


def _jax_references(jmodel, jsd, params, sd_params, inputs, key):
    """JAX's forwards and three steps with the params sharded over a (1, 2)
    mesh (tests/test_tp.py's recipe)."""
    import jax
    import jax.numpy as jnp

    from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
    from phendiff_tpu.core import make_schedule as jax_make_schedule
    from phendiff_tpu.parallel import make_mesh as jax_make_mesh
    from phendiff_tpu.parallel import shard_batch as jax_shard_batch
    from phendiff_tpu.parallel import shard_params as jax_shard_params
    from phendiff_tpu.parallel import shard_train_state as jax_shard_train_state
    from phendiff_tpu.train import train_loop as JT

    jmesh = jax_make_mesh(jax.devices()[:2], model_parallel=MP)
    out = {}
    x, t, y = jax_shard_batch(jmesh, (inputs["x"], inputs["t"], inputs["y"]))
    out["ddim"] = np.asarray(jax.jit(lambda p, a, b, c: jmodel.apply(p, a, b, class_labels=c))(
        jax_shard_params(params, jmesh), x, t, y))
    sx, st, sc = jax_shard_batch(jmesh, (inputs["sd_x"], inputs["sd_t"], inputs["sd_ctx"]))
    out["sd"] = np.asarray(jax.jit(lambda p, a, b, c: jsd.apply(p, a, b, c))(
        jax_shard_params(sd_params, jmesh), sx, st, sc))

    jcfg = JT.TrainConfig(proba_uncond=PROBA_UNCOND, optimizer=JT.OptimizerConfig(**OPT))
    jopt = JT.make_optimizer(jcfg.optimizer)
    jstep = jax.jit(JT.make_train_step(
        lambda p, a, b, ce: jmodel.apply(p, a, b, class_emb=ce),
        lambda p, lab: p["params"]["class_embedding"]["embedding"][lab],
        jax_make_schedule(JaxSchedulerConfig(num_train_timesteps=T_STEPS)), jcfg, jopt))
    jstate = jax_shard_train_state(JT.init_train_state(params, jopt), jmesh)
    jbatch = jax_shard_batch(jmesh, (jnp.asarray(inputs["images"]), jnp.asarray(inputs["labels"])))
    cfg = UNet2DConfig(**TINY_ATTN)
    train = {"loss": [], "grad_norm": []}
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, key)
        train["loss"].append(float(jm["loss"]))
        train["grad_norm"].append(float(jm["grad_norm"]))
        if i in (0, 2):
            train[f"params_{i + 1}"] = _to_torch(jstate.params, cfg)
            train[f"ema_{i + 1}"] = _to_torch(jstate.ema_params, cfg)
    out["train"] = train
    return out


@pytest.fixture(scope="session")
def runs(tmp_path_factory, tiny_image_root):
    """Inputs written once; the 1 x 2 and 2 x 2 worlds started together; the
    port's world 1 and the JAX references computed while they run."""
    import jax
    import jax.numpy as jnp

    root = str(tmp_path_factory.mktemp("tp"))
    jmodel, jsd = _jax_models()
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.array([0]),
                         class_labels=jnp.array([0]))
    sd_params = jsd.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                         jnp.zeros((1, 77, 24)))
    rng = np.random.default_rng(1)
    key = jax.random.key(7)
    images = rng.uniform(-1, 1, (GLOBAL_BATCH, 8, 8, 3)).astype(np.float32)
    inputs = {
        "params": _to_torch(params, UNet2DConfig(**TINY_ATTN)),
        "sd_params": _to_torch(sd_params, SDUNetConfig(**TINY_SD)),
        "images": images, "labels": np.array([0, 1, 1, 0, 1, 0, 0, 1], dtype=np.int32),
        "draws": [_jax_draws(key, s, images.shape) for s in range(3)],
        "x": rng.standard_normal((FWD_BATCH, 8, 8, 3)).astype(np.float32),
        "t": np.array([0, 3, 7, 11]), "y": np.array([0, 1, 0, 1]),
        "sd_x": rng.standard_normal((FWD_BATCH, 8, 8, 4)).astype(np.float32),
        "sd_t": np.array([0, 5, 9, 13]),
        "sd_ctx": rng.standard_normal((FWD_BATCH, 77, 24)).astype(np.float32),
        "data": str(tiny_image_root),
    }
    inputs_path = os.path.join(root, "inputs.pt")
    torch.save(inputs, inputs_path)

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), inputs_path, root, str(world), str(rank),
         os.path.join(root, f"rendezvous_{tag}")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, tag in WORLDS for rank in range(world)]

    # world 1 and JAX, while the workers run
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"mesh": _mesh_scenario(1), "forward": _forward_scenario(inputs, 1),
               "train": _train_scenario(inputs, 1),
               "trainer": _trainer_scenario(inputs["data"], os.path.join(root, "w1"), 1, True)}
    finally:
        torch.set_num_threads(threads)
    jax_ref = _jax_references(jmodel, jsd, params, sd_params, inputs, key)

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
    got = {f"{tag}_rank{r}": torch.load(os.path.join(root, f"{tag}_rank{r}.pt"),
                                        weights_only=False)
           for world, tag in WORLDS for r in range(world)}
    return {"root": root, "inputs": inputs, "w1": one, "jax": jax_ref, **got}


def _ranks(world):
    return [f"w{world}_rank{r}" for r in range(world)]


def _assert_params_close(got, want, what):
    assert got.keys() == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")


# -- the name rules: the JAX module's, leaf for leaf ---------------------------

def _flax_leaves(tree):
    import jax

    return [(tuple(e.key for e in path if isinstance(e, jax.tree_util.DictKey)), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("family", ["ddim", "sd"])
@pytest.mark.parametrize("size", [2, 4])
def test_tp_spec_equals_the_jax_rules_for_every_leaf(family, size):
    import jax
    import jax.numpy as jnp

    from phendiff_tpu.parallel import tp_spec as jax_tp_spec

    jmodel, jsd = _jax_models()
    if family == "ddim":
        tree = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.array([0]),
                           class_labels=jnp.array([0]))
    else:
        tree = jsd.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                        jnp.zeros((1, 77, 24)))
    leaves = _flax_leaves(tree)
    sharded = 0
    for path, shape in leaves:
        want = tuple(jax_tp_spec(path, shape, size))
        assert tp.tp_spec(path, shape, size) == want, path
        sharded += any(want)
    assert sharded >= 8
    # the torch names map to the same Flax leaves and specs
    cfg = UNet2DConfig(**TINY_ATTN) if family == "ddim" else SDUNetConfig(**TINY_SD)
    torch_params = _to_torch(tree, cfg)
    table = "\n".join(sorted(tp.describe(torch_params, size).splitlines()))
    assert len(table.splitlines()) == sharded
    for name, t in torch_params.items():
        path, fshape = tp.flax_leaf(name, t.shape)
        ax = tp.torch_axis(name, t.shape, size)
        assert (ax is not None) == any(tp.tp_spec(path, fshape, size)), name


def test_shards_join_back_in_the_per_head_layout():
    t = torch.arange(2 * 24, dtype=torch.float32).reshape(24, 2)  # q|k|v of 8 rows each
    shards = [tp.local_slice(t, 0, 3, 2, r) for r in range(2)]
    # rank 0 holds its heads of q, then of k, then of v: rows 0-3, 8-11, 16-19
    np.testing.assert_array_equal(shards[0][:, 0].numpy() // 2,
                                  [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19])
    assert torch.equal(tp.join_slices(shards, 0, 3), t)
    assert torch.equal(tp.join_slices([tp.local_slice(t, 1, 1, 2, r) for r in range(2)], 1, 1), t)


# -- the mesh ------------------------------------------------------------------

def test_make_mesh_lays_out_model_ranks_consecutively(runs):
    for world in (2, 4):
        for r, name in enumerate(_ranks(world)):
            m = runs[name]["mesh"]
            assert m["layout"] == {mesh.DATA_AXIS: world // MP, mesh.MODEL_AXIS: MP}
            assert m["data"] == (world // MP, r // MP) and m["model"] == (MP, r % MP)
            assert m["main"] == (r == 0)
            # both model ranks of a replica hold the same rows of a batch
            np.testing.assert_array_equal(m["rows"].numpy().ravel(),
                                          np.arange(4 * (r // MP), 4 * (r // MP) + 4))
            np.testing.assert_array_equal(m["gathered"].numpy().ravel(),
                                          np.arange(4 * (world // MP)))


# -- forwards --------------------------------------------------------------------

@pytest.mark.parametrize("family", ["ddim", "sd"])
def test_forwards_on_shards_equal_world_1_and_jax_on_a_1x2_mesh(runs, family):
    one = runs["w1"]["forward"][family].numpy()
    want = runs["jax"][family]
    np.testing.assert_allclose(one, want, rtol=FWD_TOL, atol=FWD_TOL)
    for world in (2, 4):
        rows = FWD_BATCH // (world // MP)
        for r, name in enumerate(_ranks(world)):
            got = runs[name]["forward"][family].numpy()
            sl = slice((r // MP) * rows, (r // MP + 1) * rows)
            np.testing.assert_allclose(got, one[sl], rtol=FWD_TOL, atol=FWD_TOL)
            np.testing.assert_allclose(got, want[sl], rtol=FWD_TOL, atol=FWD_TOL)


def test_a_bf16_forward_on_shards_is_world_1_to_bf16_rounding(runs):
    # bf16 through the collectives (the card's compute dtype); the partial
    # sums are added in f32 and rounded once, as the unsharded layer rounds
    one = runs["w1"]["forward"]["ddim_bf16"].float()
    for world in (2, 4):
        rows = FWD_BATCH // (world // MP)
        for r, name in enumerate(_ranks(world)):
            got = runs[name]["forward"]["ddim_bf16"]
            sl = slice((r // MP) * rows, (r // MP + 1) * rows)
            assert got.dtype == torch.float32  # the input's dtype, as world 1
            assert float((got - one[sl]).norm() / one[sl].norm()) < 2e-2


@pytest.mark.parametrize("family", ["ddim", "sd"])
def test_every_block_of_the_tiny_models_runs_on_shards(runs, family):
    plan = runs["w2_rank0"]["forward"][f"{family}_plan"]
    layers = {n.rsplit(".", 2)[-2] for n in plan}
    want = ({"conv_in", "conv1", "conv2", "conv", "qkv", "proj_out"} if family == "ddim" else
            {"conv_in", "conv1", "conv2", "conv", "to_q", "to_k", "to_v", "to_out",
             "proj_in", "proj_out"})
    assert layers == want
    assert all(runs["w2_rank0"]["forward"][f"{family}_plan"][n][1] == 3
               for n in plan if ".qkv." in n)


# -- train steps -----------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("world", [2, 4])
def test_train_steps_on_shards_match_world_1_and_the_jax_step(runs, world, steps):
    one, jax_train = runs["w1"]["train"], runs["jax"]["train"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(one[key][:steps], jax_train[key][:steps], rtol=LOSS_RTOL)
    for name in _ranks(world):
        got = runs[name]["train"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key][:steps], one[key][:steps], rtol=LOSS_RTOL)
        for what in ("params", "ema"):
            _assert_params_close(got[f"{what}_{steps}"], one[f"{what}_{steps}"],
                                 f"{what} vs world 1, {name}")
            _assert_params_close(got[f"{what}_{steps}"], jax_train[f"{what}_{steps}"],
                                 f"{what} vs JAX, {name}")


@pytest.mark.parametrize("world", [2, 4])
def test_replicated_leaves_stay_bit_equal_and_shards_keep_their_shapes(runs, world):
    full = runs["inputs"]["params"]
    names = _ranks(world)
    plan = runs[names[0]]["train"]["plan"]
    assert plan  # something is sharded
    for pair in (names[i:i + MP] for i in range(0, world, MP)):  # one replica's ranks
        a, b = (runs[n]["train"]["local"] for n in pair)
        for n, t in a.items():
            if n in plan:
                dim, _ = plan[n]
                want = list(full[n].shape)
                want[dim] //= MP
                assert list(t.shape) == want == list(b[n].shape), n
            else:
                assert t.shape == full[n].shape and torch.equal(t, b[n]), n


# -- the Trainer -------------------------------------------------------------------

def test_trainer_at_model_parallel_2_gives_the_world_1_losses(runs):
    one, two = runs["w1"]["trainer"], runs["w2_rank0"]["trainer"]
    assert two["lr_scale"] == one["lr_scale"] == 1.0  # sqrt(data size), data size 1
    assert len(one["losses"]) == len(two["losses"]) == 8
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=LOSS_RTOL)
    for key in ("first_params", "final_params"):
        _assert_params_close(two[key], one[key], key)
        _assert_params_close(runs["w2_rank1"]["trainer"][key], two[key], key)


def test_trainer_checkpoint_is_the_full_tree_and_resumes(runs):
    from phendiff_tpu_torch.train.checkpoints import CheckpointManager

    two = runs["w2_rank0"]["trainer"]
    assert (two["first_steps"], tuple(two["resume_start"]), two["final_steps"]) == (4, (1, 0), 8)
    for n, t in two["first_params"].items():  # the resume cut the checkpoint again
        assert torch.equal(two["resumed_params"][n], t), n
    # the TP run's checkpoint loads at world 1, whole
    ckpt = CheckpointManager(os.path.join(runs["root"], "w2", "exp", "run0", "checkpoints"))
    assert ckpt.all_steps() == [2, 4, 6, 8]
    state = T.init_train_state({n: t.clone() for n, t in two["final_params"].items()},
                               T.make_optimizer(T.OptimizerConfig()))
    ckpt.restore(state, 8)
    full = runs["inputs"]["params"]
    for n, t in state.params.items():
        assert t.shape == full[n].shape
        assert torch.equal(t.detach(), two["final_params"][n]), n


def test_trainer_with_bf16_moments_checkpoints_and_resumes_bit_equal(runs):
    """At 1 x 2 the checkpoint gathers the bf16 first moments over gloo and
    the resume cuts them again: every tensor of the full state comes back
    bit for bit, the first moments still bf16 on both model ranks."""
    for name in _ranks(2):
        b = runs[name]["bf16_trainer"]
        assert b["local_mu_dtypes"] == b["resumed_local_mu_dtypes"] == {"torch.bfloat16"}
        assert b["local_nu_dtypes"] == {"torch.float32"}
        assert (tuple(b["resume_start"]), b["final_steps"]) == ((1, 0), 8)
        saved, resumed = b["saved"], b["resumed"]
        assert saved["count"] == resumed["count"] == 4
        assert {str(t.dtype) for t in saved["mu"].values()} == {"torch.bfloat16"}
        for part in ("params", "mu", "nu"):
            assert saved[part].keys() == resumed[part].keys() == runs["inputs"]["params"].keys()
            for n, t in saved[part].items():
                assert t.shape == runs["inputs"]["params"][n].shape, (part, n)
                assert torch.equal(resumed[part][n], t), (part, n)
    # both model ranks gathered the same full tree
    r0, r1 = (runs[name]["bf16_trainer"]["saved"] for name in _ranks(2))
    for part in ("params", "mu", "nu"):
        for n, t in r0[part].items():
            assert torch.equal(r1[part][n], t), (part, n)


def test_trainer_at_2x2_shards_the_loader_by_data_rank(runs):
    for r, name in enumerate(_ranks(4)):
        t = runs[name]["trainer"]
        # 32 images, 2 replicas: batches of 8 // 2, the replica's shard on both its model ranks
        assert (t["loader_batch"], t["num_shards"], t["shard_index"]) == (4, 2, r // MP)
        assert t["lr_scale"] == np.sqrt(2)

