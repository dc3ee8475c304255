"""The port's DiT (``models/dit.py``) and its latent pipeline
(``pipelines/dit_img2img.py``) against the benchmark's plain float32
reference (``portbench/reference/dit.py``), on the CPU at a tiny size:
depth 2, hidden 144, 2 heads of 72 (DiT-XL/2's head dim), 8 x 8 latents
(16 tokens), 10 classes, learned sigma; weights drawn from a seed by the
benchmark's own law (``harness/weights.py``), so the adaLN and final
layers are not DiT's zeros.

The JAX package has no DiT: the reference is the oracle, and DiT's own
formulas (its ``get_2d_sincos_pos_embed`` and ``timestep_embedding``,
written out below as ``models.py`` has them) are the oracle of the fixed
embeddings.  Each tolerance is stated with its reason beside it.
"""

import json
import math

import numpy as np
import pytest
import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.models import dit as port
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
from phendiff_tpu_torch.pipelines.dit_img2img import DIT_SCHEDULER, DiTImg2ImgPipeline
from phendiff_tpu_torch.pipelines.transfer import ddib
from portbench.harness.weights import make_weights, specs_of
from portbench.reference import diffusion as D
from portbench.reference import dit as ref
from portbench.reference.models import Arith

torch.set_num_threads(1)

TINY = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=144, depth=2, num_heads=2,
            mlp_ratio=4.0, num_classes=10, learn_sigma=True)
XL2 = port.DiTConfig()


def _models(seed=0):
    """The port's DiT and the reference, on the same drawn weights."""
    with torch.device("meta"):
        specs = specs_of({"dit": ref.DiT(TINY)})
    weights = {n[4:]: w for n, w in make_weights(specs, seed, "cpu").items()}
    reference = ref.DiT(TINY)
    reference.load_state_dict(weights)
    model = port.DiT(port.DiTConfig.from_json(TINY))
    model.load_state_dict({**weights, "pos_embed": model.fixed_pos_embed()})
    return model, reference


def _inputs(b=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 8, 8, 4, generator=g)
    t = torch.tensor([0, 480, 999][:b])
    y = torch.tensor([3, 10, 7][:b])  # 10: the null class
    return x, t, y


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_forward_f32_matches_the_reference():
    model, reference = _models()
    x, t, y = _inputs()
    with torch.no_grad():
        got, want = model(x, t, y), reference(Arith(), x, t, reference.embed(y))
    assert got.shape == want.shape == (3, 8, 8, 8) and got.dtype == torch.float32
    # f32 against f32: summation order alone, ~1e-7 a product; 1e-5 relative
    # holds it, and a bf16 computation (2^-9 a rounding, ~3e-3 here) fails it
    assert _rel(got, want) < 1e-5


def test_forward_bf16_stays_near_the_reference():
    model, reference = _models()
    x, t, y = _inputs()
    model.dtype = torch.bfloat16
    with torch.no_grad():
        got, want = model(x, t, y), reference(Arith(), x, t, reference.embed(y))
    assert got.dtype == torch.float32
    # bf16 activations over 2 blocks: ~4e-3 relative; 2e-2 holds it, while
    # the output of other weights (a wrong layer, a lost gate) is O(1) away
    err = _rel(got, want)
    assert 1e-4 < err < 2e-2, err


def test_pos_embed_is_dits_table():
    """DiT's ``get_2d_sincos_pos_embed`` as ``models.py`` writes it."""
    def get_1d(embed_dim, pos):
        omega = np.arange(embed_dim // 2, dtype=np.float64)
        omega /= embed_dim / 2.0
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    def get_2d(embed_dim, grid_size):
        grid = np.meshgrid(np.arange(grid_size, dtype=np.float32),
                           np.arange(grid_size, dtype=np.float32))
        grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
        return np.concatenate([get_1d(embed_dim // 2, grid[0]), get_1d(embed_dim // 2, grid[1])],
                              axis=1)

    for cfg in (port.DiTConfig.from_json(TINY), XL2):
        with torch.device("meta"):
            model = port.DiT(cfg)
        table = model.fixed_pos_embed()[0].numpy()
        want = get_2d(cfg.hidden_size, cfg.grid_size)
        # float32 storage of float64 sines: 6e-8 absolute
        np.testing.assert_allclose(table, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ref.sincos_2d(cfg.hidden_size, cfg.grid_size).numpy(), want,
                                   rtol=0, atol=1e-6)
    # the column's half first: token 1 (row 0, column 1) differs from token 0 there
    assert not np.allclose(want[1, :cfg.hidden_size // 2], want[0, :cfg.hidden_size // 2])
    np.testing.assert_array_equal(want[1, cfg.hidden_size // 2:], want[0, cfg.hidden_size // 2:])


def test_timestep_embedding_is_dits():
    """DiT's ``TimestepEmbedder.timestep_embedding``: [cos, sin], the
    opposite order to pos_embed's halves."""
    t = torch.tensor([0, 1, 20, 980, 999])
    half = 128
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32) / half)
    args = t[:, None].float() * freqs[None]
    want = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    model, _ = _models()
    got = port.sinusoidal_timestep_embedding(t, port.FREQUENCY_EMBEDDING_SIZE,
                                             flip_sin_to_cos=True)
    # the same float32 ops: bit-equal but for libm's sin/cos rounding
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with torch.no_grad():
        emb = model.t_embedder(t, torch.float32)
        mlp = model.t_embedder.mlp
        torch.testing.assert_close(emb, mlp[2](torch.nn.functional.silu(mlp[0](want))),
                                   rtol=0, atol=1e-6)


def test_the_denoiser_keeps_the_eps_half():
    model, reference = _models()
    vae = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                              norm_num_groups=4, latent_channels=4, sample_size=64)
    pipe = DiTImg2ImgPipeline.init_random(model.config, vae, seed=0, device="cpu")
    pipe.dit.load_state_dict(model.state_dict())
    x, t, y = _inputs()
    with torch.no_grad():
        full = pipe.dit(x, t, y)
        eps = pipe.denoiser_fn()(x, t, pipe.encode_class(y))
    assert eps.shape == (3, 8, 8, 4)
    torch.testing.assert_close(eps, full[..., :4], rtol=0, atol=0)
    assert not torch.allclose(full[..., 4:], full[..., :4])
    rows = pipe.encode_class([1, 2])
    table = pipe.dit.y_embedder.embedding_table.weight
    torch.testing.assert_close(rows, table[[1, 2]], rtol=0, atol=0)
    torch.testing.assert_close(pipe.uncond_class(rows), table[[10, 10]], rtol=0, atol=0)
    # labels or their rows: one output
    with torch.no_grad():
        torch.testing.assert_close(pipe.dit(x, t, pipe.encode_class(y)), full, rtol=0, atol=0)


def test_ddib_with_the_dit_denoiser_follows_the_reference_steps():
    """The port's ``ddib`` over the DiT denoiser against the reference's
    DDIM steps (``reference/diffusion.py``) under DiT's schedule, 5 + 5
    steps, f32: each port state against the reference's step from the
    port's previous state."""
    model, reference = _models()
    sched = S.make_schedule(DIT_SCHEDULER, device="cpu")
    rsched = D.Schedule(dict(DIT_SCHEDULER.to_json_dict()), "cpu")
    x, _, y = _inputs(2)
    src, tgt = y[:2], torch.tensor([1, 0])
    states = []

    def denoiser(z, t, labels):
        states.append(z.clone())
        return model.eps_of(model(z, t, labels))

    out = ddib(denoiser, sched, x, src, tgt, num_inference_steps=5)
    rows = rsched.ddib_rows(5)
    assert [r[0] for r in rows[5:]] == [800, 600, 400, 200, 0]  # leading, offset 0
    assert len(states) == len(rows) == 10
    with torch.no_grad():
        for k, (te, tt, gen) in enumerate(rows):
            z = states[k]
            t = torch.full((2,), max(te, 0), dtype=torch.long)
            eps = reference(Arith(), z, t, reference.embed(tgt if gen else src))[..., :4]
            want = D.ddib_step(rsched, eps, z, te, tt, gen)
            got = states[k + 1] if k + 1 < len(rows) else out
            step = (want - z).double().flatten(1).norm(dim=1)
            gap = (got - want).double().flatten(1).norm(dim=1) / step
            # f32 both sides: 1e-4 of a step; bf16 would read ~1e-2
            assert float(gap.max()) < 1e-4, (k, gap)


def test_published_parameter_count_and_state_dict_names():
    with torch.device("meta"):
        model = port.DiT(XL2)
        reference = ref.DiT(dict(TINY, depth=28, hidden_size=1152, num_heads=16, input_size=64,
                                 num_classes=1000))
    assert sum(p.numel() for p in model.parameters()) == 674_834_720
    assert sum(p.numel() for p in reference.parameters()) == 674_834_720
    keys = list(model.state_dict())
    assert len(keys) == 292 and keys[0] == "pos_embed"
    assert {"x_embedder.proj.weight", "t_embedder.mlp.0.weight", "t_embedder.mlp.2.bias",
            "y_embedder.embedding_table.weight", "blocks.27.attn.qkv.weight",
            "blocks.0.attn.proj.bias", "blocks.3.mlp.fc1.weight", "blocks.3.mlp.fc2.bias",
            "blocks.12.adaLN_modulation.1.weight", "final_layer.adaLN_modulation.1.bias",
            "final_layer.linear.weight"} <= set(keys)
    assert model.state_dict()["y_embedder.embedding_table.weight"].shape == (1001, 1152)
    assert model.state_dict()["final_layer.linear.weight"].shape == (32, 1152)
    assert "pos_embed" not in dict(model.named_parameters())
    # the reference's parameters are the port's, name for name
    assert set(dict(reference.named_parameters())) == set(keys) - {"pos_embed"}
    assert XL2.head_dim == 72 and XL2.out_channels == 8 and XL2.grid_size == 32


def test_glue_counter_and_forward_counter():
    model, _ = _models()
    x, t, y = _inputs()
    g0, f0 = port.glue_launches, port.forward_calls
    with torch.no_grad():
        model(x, t, y)
        model(x, t, y)
    # 7 a block (2 norms, 2 modulates, 2 gated residuals, GELU), 2 final
    assert port.glue_launches - g0 == 2 * (7 * TINY["depth"] + 2)
    assert port.forward_calls - f0 == 2


def test_glue_counter_counts_the_ops_that_dispatch():
    """The counter is one a dispatched LayerNorm, addcmul (modulate and
    gated residual) or GELU op of a forward, as the dispatcher sees them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    glue = {torch.ops.aten.native_layer_norm.default, torch.ops.aten.addcmul.default,
            torch.ops.aten.gelu.default}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in glue
            return func(*args, **(kwargs or {}))

    model, _ = _models()
    x, t, y = _inputs()
    g0 = port.glue_launches
    with torch.no_grad(), Count():
        model(x, t, y)
    assert port.glue_launches - g0 == Count.n == 7 * TINY["depth"] + 2


def test_forward_is_bit_equal_to_the_block_order_before_the_boundaries():
    """The forward that carries (x, z) across sub-layer boundaries against
    the block order it replaced, written out: each block's LN, modulate,
    attention, gated residual, then the same around the MLP, and the final
    layer's LN and modulate.  On the CPU every boundary is that
    composition, so float32 outputs are equal bit for bit."""
    import torch.nn.functional as F

    def ln(x):
        return F.layer_norm(x, x.shape[-1:], eps=port.LN_EPS)

    def mod(x, shift, scale1p):
        return torch.addcmul(shift[:, None], x, scale1p[:, None])

    model, _ = _models()
    x, t, y = _inputs()
    with torch.no_grad():
        mods, fin = model.condition(t, y, torch.float32)
        h = model.x_embedder(x) + model.pos_embed
        for block, m in zip(model.blocks, mods):
            shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = m.unbind(1)
            h = torch.addcmul(h, gate_msa[:, None], block.attn(mod(ln(h), shift_msa, scale_msa)))
            h = torch.addcmul(h, gate_mlp[:, None], block.mlp(mod(ln(h), shift_mlp, scale_mlp)))
        out = model.final_layer.linear(mod(ln(h), fin[:, 0], fin[:, 1]))
        p, oc = TINY["patch_size"], model.config.out_channels
        want = out.reshape(3, 4, 4, p, p, oc).permute(0, 1, 3, 2, 4, 5).reshape(3, 8, 8, oc)
        got = model(x, t, y)
    assert torch.equal(got, want)


def test_pipeline_folder_round_trip(tmp_path):
    vae = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                              norm_num_groups=4, latent_channels=4, sample_size=64)
    pipe = DiTImg2ImgPipeline.init_random(port.DiTConfig.from_json(TINY), vae, seed=3,
                                          device="cpu")
    pipe.save_pretrained(str(tmp_path / "p"))
    back = DiTImg2ImgPipeline.from_pretrained(str(tmp_path / "p"), device="cpu")
    for a, b in ((pipe.dit, back.dit), (pipe.vae, back.vae)):
        for (n, u), (_, v) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(u, v, rtol=0, atol=0, msg=n)
    assert back.scheduler_config == DIT_SCHEDULER == pipe.scheduler_config
    images = torch.rand(2, 64, 64, 3) * 2 - 1
    lat = back.encode_images(images)
    assert lat.shape == (2, 8, 8, 4) and back.decode_latents(lat).shape == (2, 64, 64, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_params_keeps_the_table_and_pos_embed_f32(dtype):
    vae = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                              norm_num_groups=4, latent_channels=4, sample_size=64)
    pipe = DiTImg2ImgPipeline.init_random(port.DiTConfig.from_json(TINY), vae, seed=3,
                                          dtype=dtype, device="cpu").cast_params(dtype)
    assert pipe.dit.blocks[0].attn.qkv.weight.dtype == dtype
    assert pipe.dit.y_embedder.embedding_table.weight.dtype == torch.float32
    assert pipe.dit.pos_embed.dtype == torch.float32
    x, t, y = _inputs()
    with torch.no_grad():
        out = pipe.denoiser_fn()(x, t, y)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def dit_folder(tmp_path_factory):
    """A tiny DiT pipeline folder and a 2-class folder of 64 px images (8 x 8
    latents through a 4-level VAE)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dit_cmp")
    vae = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                              norm_num_groups=4, latent_channels=4, sample_size=64)
    pipe = DiTImg2ImgPipeline.init_random(port.DiTConfig.from_json(TINY), vae, seed=5,
                                          device="cpu")
    pipe.save_pretrained(str(root / "pipe"))
    rng = np.random.default_rng(0)
    for cls in ("DMSO", "drug"):
        (root / "data" / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
                root / "data" / cls / f"img_{i}.png")
    return root


def test_img2img_cli_runs_a_tiny_dit_transfer(dit_folder, tmp_path):
    import yaml

    from phendiff_tpu_torch.cli.img2img_cli import main as cli_main

    methods = ["ddib", "inverted_regeneration", "classifier_free_guidance_forward_start"]
    conf = {"output_dir": str(tmp_path / "out"), "pipelines": {"dit": str(dit_folder / "pipe")},
            "dataset_train": str(dit_folder / "data"), "definition": [64, 64],
            "methods": methods, "method_params": {m: {"batch_size": 4} for m in methods},
            "num_inference_steps": 2, "metrics": {"fid": False, "isc": False, "kid": False}}
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    assert cli_main(["--config", str(tmp_path / "conf.yaml"), "--device", "cpu"]) == 0
    for m in methods:
        pngs = sorted((tmp_path / "out" / m / "dit" / "train").rglob("*_to_*.png"))
        assert len(pngs) == 4, m
    with open(tmp_path / "out" / "timings.json") as f:
        assert json.load(f)["ddib/dit"]["images"] == 4


def test_comparison_gives_dit_the_null_class_and_refuses_the_guided_method(dit_folder):
    from phendiff_tpu_torch.experiments import comparison

    pipe = DiTImg2ImgPipeline.from_pretrained(str(dit_folder / "pipe"), device="cpu")
    seen = []
    real = pipe.denoiser_fn()
    params = comparison.MethodParams(guidance_scale=2.5)
    fn = comparison._make_transfer_fn(pipe, "classifier_free_guidance_forward_start", params,
                                      2, denoiser=lambda x, t, y: seen.append(y) or real(x, t, y))
    images = torch.rand(2, 64, 64, 3) * 2 - 1
    out = fn(images, torch.tensor([0, 1]), torch.tensor([1, 0]), torch.Generator().manual_seed(0))
    assert out.shape == (2, 64, 64, 3)
    # cond and uncond in one batch: the targets' rows, then the null class's
    table = pipe.dit.y_embedder.embedding_table.weight
    assert seen and all(torch.equal(y, table[[1, 0, 10, 10]]) for y in seen)
    with pytest.raises(ValueError, match="need no gradient"):
        comparison._make_transfer_fn(pipe, "linear_interp_custom_guidance_inverted_start",
                                     params, 2)


def test_factory_loads_a_dit_folder_at_its_definition(dit_folder):
    import types

    from phendiff_tpu_torch.cli import factory

    args = types.SimpleNamespace(
        model_type="DiT", pretrained_model_name_or_path=str(dit_folder / "pipe"),
        definition=(64, 64), noise_scheduler_config_path=None, prediction_type=None,
        num_train_timesteps=None, beta_start=None, beta_end=None, beta_schedule=None)
    pipe = factory.load_initial_pipeline(args, device="cpu")
    assert isinstance(pipe, DiTImg2ImgPipeline) and pipe.scheduler_config == DIT_SCHEDULER
    args.beta_end = 0.03  # the command line's scheduler values win
    assert factory.load_initial_pipeline(args, device="cpu").scheduler_config.beta_end == 0.03
    args.definition = (128, 128)
    with pytest.raises(ValueError, match="takes 64 px"):
        factory.load_initial_pipeline(args, device="cpu")
