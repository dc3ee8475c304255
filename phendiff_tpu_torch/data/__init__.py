"""Training data: the image-folder dataset, the HF-datasets adapter and the
native resize library (``data/native.py``)."""

from phendiff_tpu_torch.data.hf_datasets import (  # noqa: F401
    HFDatasetAdapter,
    load_hf_dataset,
    load_hf_imagefolder,
)
from phendiff_tpu_torch.data.imagefolder import (  # noqa: F401
    DatasetIndex,
    ImageFolderLoader,
    LoaderConfig,
    balanced_subsample,
    load_image,
    scan_imagefolder,
)
