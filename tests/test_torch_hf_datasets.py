"""The port's HF-datasets adapter against the JAX package's, on the CPU.

A local image folder (loaded as an HF ``"imagefolder"``) and an arrow
dataset with a plain integer label column (saved to disk) are made in
``tmp_path``.  Both packages' adapters must yield equal batches: the same
epoch order and flips from the same seeds, and the same native resize.
The label remap (raw values 3 and 7 to classes 0 and 1), ``for_class``
and the Evaluator's raw-image pass agree too, and the training CLI builds
its loader from ``--dataset_name``.
"""

import json

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from phendiff_tpu.data import hf_datasets as jax_hf  # noqa: E402
from phendiff_tpu.data.imagefolder import LoaderConfig as JaxLoaderConfig  # noqa: E402
from phendiff_tpu_torch.cli import args as A  # noqa: E402
from phendiff_tpu_torch.cli import train_cli  # noqa: E402
from phendiff_tpu_torch.data import hf_datasets  # noqa: E402
from phendiff_tpu_torch.data.imagefolder import LoaderConfig, scan_imagefolder  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.train.eval_loop import EvalConfig, Evaluator  # noqa: E402
from phendiff_tpu_torch.train.trainer import build_data  # noqa: E402

TINY_UNET = UNet2DConfig(
    sample_size=16, block_out_channels=(8, 8),
    down_block_types=("DownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, num_class_embeds=2,
)
LOADER = dict(batch_size=4, definition=(16, 16), seed=5, random_flip=True)


@pytest.fixture(scope="module")
def arrow_dir(tmp_path_factory):
    """12 random 24 px images with integer labels 3 and 7, saved to disk."""
    from PIL import Image

    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8))
            for _ in range(12)]
    ds = datasets.Dataset.from_dict({"image": imgs, "label": [3, 7, 7] * 4})
    ds = ds.cast_column("image", datasets.Image())
    path = str(tmp_path_factory.mktemp("arrow"))
    ds.save_to_disk(path)
    return path


def _both(path):
    return (hf_datasets.load_hf_dataset(path, LoaderConfig(**LOADER)),
            jax_hf.load_hf_dataset(path, JaxLoaderConfig(**LOADER)))


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_imagefolder_batches_match_the_jax_adapter(tiny_image_root):
    port, ref = _both(str(tiny_image_root))
    assert port.classes == ref.classes == ("DMSO", "drug")
    assert len(port) == len(ref) == 8
    for epoch in (0, 1):
        _assert_same_batches(list(port.epoch(epoch)), list(ref.epoch(epoch)))
    _assert_same_batches(list(port.epoch(1, skip_batches=3)), list(ref.epoch(1, skip_batches=3)))


def test_arrow_dataset_label_remap_and_for_class_match_the_jax_adapter(arrow_dir):
    port, ref = _both(arrow_dir)
    assert port.classes == ref.classes == ("3", "7")
    _assert_same_batches(list(port.epoch(2)), list(ref.epoch(2)))
    labels = np.concatenate([lab for _, lab in port.epoch(0)])
    assert sorted(set(labels.tolist())) == [0, 1]
    for c in (0, 1):
        sub, jsub = port.for_class(c), ref.for_class(c)
        assert len(sub.dataset) == len(jsub.dataset) == (4 if c == 0 else 8)
        _assert_same_batches(list(sub.raw_images(3, (8, 8))), list(jsub.raw_images(3, (8, 8))))
        _assert_same_batches(list(sub.epoch(0)), list(jsub.epoch(0)))


class _MeanExtractor:
    """Stands in for the Inception: a batch's per-image channel means."""

    device = "cpu"
    pretrained = True

    def features_for(self, batches):
        feats = np.concatenate([b.mean(axis=(1, 2)) for b in batches])
        return feats, None


def test_evaluator_reference_features_through_the_adapter(tiny_image_root):
    """The Evaluator reads the HF route's reference set through
    ``raw_images``: the same images as the folder route's, in another order."""
    adapter = hf_datasets.load_hf_imagefolder(str(tiny_image_root), LoaderConfig(**LOADER))
    cfg = EvalConfig(eval_batch_size=5)
    ev = Evaluator(cfg, adapter, (16, 16), extractor=_MeanExtractor())
    folder = Evaluator(cfg, scan_imagefolder(str(tiny_image_root)), (16, 16),
                       extractor=_MeanExtractor())
    for c, name in enumerate(adapter.classes):
        got, want = ev._reference_features(c, name), folder._reference_features(c, name)
        assert got.shape == want.shape == (16, 3)
        np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(want, axis=0))
    assert ev._cache_key(0, "DMSO") != ev._cache_key(1, "DMSO")


def test_train_cli_dataset_name_builds_its_loader(tiny_image_root, tmp_path, capsys):
    dpath = tmp_path / "denoiser.json"
    dpath.write_text(json.dumps(TINY_UNET.to_json_dict()))
    argv = ["--run_name", "hf", "--model_type", "DDIM", "--dataset_name", str(tiny_image_root),
            "--denoiser_config_path", str(dpath), "--definition", "16",
            "--train_batch_size", "8", "--eval_save_model_every_epochs", "1"]
    args = A.build_parser().parse_args(argv)
    A.check_args(args)
    index, loader, eval_index = build_data(train_cli.trainer_config_from_args(args))
    assert isinstance(loader, hf_datasets.HFDatasetAdapter)
    assert index is loader is eval_index and loader.classes == ("DMSO", "drug")
    images, labels = next(iter(loader.epoch(0)))
    assert images.shape == (8, 16, 16, 3) and labels.shape == (8,)
    args.perc_samples = 50
    with pytest.raises(NotImplementedError, match="perc_samples"):
        build_data(train_cli.trainer_config_from_args(args))
    # the whole entry point, --debug: 3 epochs of the adapter's 4 batches
    rc = train_cli.main(argv + [
        "--eval_batch_size", "4", "--nb_generated_images", "4", "--no_compute_fid",
        "--exp_output_dirs_parent_folder", str(tmp_path / "exp"), "--mixed_precision", "no",
        "--debug", "--device", "cpu"])
    assert rc == 0 and "done: 12 steps" in capsys.readouterr().out
