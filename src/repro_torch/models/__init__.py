"""Model zoo: the unified block-pattern LM (``lm.py``) over the configs of
``repro_torch.configs``; whisper (enc-dec) has its own assembly
(``encdec.py``) on the same attention substrate."""

from repro_torch.models.config import BlockSpec, ModelConfig  # noqa: F401
from repro_torch.models.encdec import (EncDec, encdec_apply,  # noqa: F401
                                       encdec_decode_step,
                                       encdec_params_from_reference,
                                       init_encdec, init_encdec_cache)
from repro_torch.models.lm import (LM, chunked_ce, init_lm,  # noqa: F401
                                   init_lm_cache, lm_apply, lm_decode_step,
                                   lm_loss, params_from_reference)
