from phendiff_tpu_torch.models.config import PRESETS, UNet2DConfig  # noqa: F401
from phendiff_tpu_torch.models.unet2d import CondUNet2D  # noqa: F401
