"""repro_torch.optim — the training stack's optimizers (counterpart of
``repro/optim``): AdamW and Adafactor updating in place, the cosine LR
schedule, and the int8 compressed gradient mean over ``core.comm``."""
from .grad_compress import (compressed_psum,  # noqa: F401
                            compressed_psum_mean, init_error_feedback)
from .optimizers import (AdafactorState, AdamWState,  # noqa: F401
                         adafactor_init, adafactor_update, adamw_init,
                         adamw_update, make_optimizer)
from .schedule import cosine_schedule  # noqa: F401
