from phendiff_tpu_torch.metrics.fidelity import (  # noqa: F401
    FeatureCache,
    MetricsConfig,
    calculate_metrics,
    fid_from_features,
    isc_from_logits,
    kid_from_features,
)
from phendiff_tpu_torch.metrics.inception import InceptionExtractor, InceptionV3  # noqa: F401
