"""repro_torch.runtime — the runtime pieces ``psort``'s fault lane needs:
the restart loop, the straggler watchdog and the fault policy
(``failures.py``), and the rescale plan of a sorting mesh
(``elastic.py``).  They are the port's own copies of the reference's
(``repro/runtime``), plain Python and numpy.

The reference's training-stack runtime (``CheckpointManager``,
``plan_rescale``, ``RescalePlan``, ``rescale_state``) comes with the
integration stack, ROADMAP queue 1 item 10."""
from .elastic import SortRescalePlan, plan_sort_rescale  # noqa: F401
from .failures import (FaultPolicy, StepWatchdog,  # noqa: F401
                       flag_stragglers, run_with_restarts)
