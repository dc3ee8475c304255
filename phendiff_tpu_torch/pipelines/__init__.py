from phendiff_tpu_torch.pipelines.conditional_ddim import (  # noqa: F401
    DEFAULT_NUM_INFERENCE_STEPS,
    GuidanceConfig,
    ddim_invert,
    ddim_sample,
    to_images,
)
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline  # noqa: F401
from phendiff_tpu_torch.pipelines.transfer import (  # noqa: F401
    TRANSFER_METHODS,
    cfg_forward_start,
    check_gaussianity,
    custom_guided_generation,
    ddib,
    guided_inverted_start,
    inverted_regeneration,
    lp_loss,
)
