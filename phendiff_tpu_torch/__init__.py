"""phendiff_tpu_torch: the PyTorch/CUDA port of phendiff_tpu for NVIDIA Hopper.

The JAX package ``phendiff_tpu`` is the reference this package is held
against.  This package imports ``torch`` (plus numpy, scipy, PIL and the
standard library) and never ``jax`` or anything of ``phendiff_tpu``.

Layout mirrors the JAX package: ``core/`` (schedules, precision, RNG),
``models/`` (config, embeddings, the conditional UNet, weight carry-over),
``ops/`` (GroupNorm and attention, forward and backward, with hand-written
CUDA kernels under ``csrc/``), ``pipelines/`` (DDIM sampling, the transfer
methods, folder I/O), ``metrics/`` (FID/ISC/KID, InceptionV3),
``experiments/`` (the comparison engine), ``cli/`` (its command line),
``train/`` (train step, EMA, checkpoints, Evaluator, Trainer), ``data/``
(image folder, native loader), ``obs/`` (trackers, images, timing,
profiles) and ``tools/`` (kernel microbenchmarks).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; importing the package builds no kernel.
"""

__version__ = "0.1.0"
