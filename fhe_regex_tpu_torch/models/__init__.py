from fhe_regex_tpu_torch.models.patterns import (  # noqa: F401
    CompiledPattern,
    CompiledPatternSet,
    CompiledPositions,
    DRIVER_CONFIGS,
)
