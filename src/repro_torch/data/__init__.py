from repro_torch.data.pipeline import (HTAPTokenPipeline,  # noqa: F401
                                       SyntheticPipeline)
