from phendiff_tpu_torch.serving.engine import EngineConfig, InferenceEngine  # noqa: F401
