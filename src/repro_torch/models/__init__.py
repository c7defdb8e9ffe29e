"""Model zoo: the unified block-pattern LM (``lm.py``) over the configs of
``repro_torch.configs``. The encoder-decoder assembly (whisper) is not
ported yet."""

from repro_torch.models.config import BlockSpec, ModelConfig  # noqa: F401
from repro_torch.models.lm import (LM, chunked_ce, init_lm,  # noqa: F401
                                   init_lm_cache, lm_apply, lm_decode_step,
                                   lm_loss, params_from_reference)
